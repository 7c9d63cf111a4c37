#!/usr/bin/env python3
"""Drive the uc2_torch paths on one CUDA card: ITM pair scoring (bf16, and
int8 serving), the mlm
pretraining step, the pretraining task mix of config/uc2_pretrain.json
(itm, mlm, vmlm, tlm) with the training FFN kernels, the pretraining
driver (python -m uc2_torch.pretrain) on U2S stores with exact resume,
every other pretraining objective (mmxlm, the soft tasks, mrfr, mrc,
mrc-kl, mrm-nce, itm-ot through IPOT, hard negatives, tlm-ni) in steps
and through the driver, the retrieval finetuning driver (python -m
uc2_torch.itm) on config/uc2_mscoco_itm.json, the VQA, VE and NLVR2
finetuning drivers (python -m uc2_torch.vqa, ve, nlvr2) with the NLVR2
scorer,
mlm pretraining on long captions (joint L up to 512), the two routes of
the attention dispatch beyond the default: scoring with UC2_ATTN_V2=1
(the QKV projection inside the attention block) and
use_pallas_attention="flash" (scoring, and training at attention dropout
0), and the port's kernel lab (python -m uc2_torch.lab, every mode) with
the two kernels only it runs, the mlm step under remat (full, dots), the
LMDB importer and the real-checkpoint runbook (python -m
uc2_torch.verify_real_ckpt) with the collate bench.

    python3 chip_smoke.py        # from the root of the repository

Phases; a failed check is reported where it happens and the run exits
non-zero at the end, without the result lines:
  1. device: the card's name and power limit, then the kernels' build
     (nvcc, sm_90a) with its time and the compiler's register report;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the shapes its path gives it (scoring: B = 64; training:
     (B, L) = (208, 98), (160, 128), (128, 162) at dropout 0.1 and 0;
     12 heads of 64, H = 768, F = 3072, bf16 inputs from a seed, padding
     masks), with times, the least time the card could take, and a
     library yardstick where one PyTorch call computes the same function;
     the FFN block (#3) also at ragged row counts and F = 128, repeated
     bit for bit, and timed from CUDA graphs beside its two products
     alone as cuBLAS calls; the attention block (#2) timed from CUDA
     graphs and on the host's clock at the fused buckets beside its eager
     chain with SDPA, at (64, 98) beside that bucket's path (#1, the eager
     out-projection and LayerNorm), and at the edges of its 64-row query
     tiles (L = 1 .. 512, B = 1-3, one grid past a wave; views into one
     projection and contiguous heads), each call repeated bit for bit;
     #6's two passes each against its plain version (row statistics; keep
     bits bit for bit); #5 beside SDPA's forward and #6 beside SDPA's
     autograd backward (both also replayed from a CUDA graph) and their
     bounds at each training shape; the training kernels' dropout mask
     against the plain Philox mask;
  3. slice: full-width uc2-base (12 layers, random weights from a seed)
     runs full_retrieval_eval over a synthetic gallery that fills the
     three region-count buckets (joint L = 98, 128, 162); every kernel's
     launch count must match the routing, one batch per bucket is held
     against the eager PyTorch path, pairs/s per bucket are timed, and one
     batch at L = 98 and at L = 162 is profiled (device busy and idle
     share, device time by kernel group);
  4. train: full-width uc2-base mlm steps (dropout 0.1, the optimizer of
     config/uc2_pretrain.json) at the three training buckets, 1 warm-up
     and 5 timed steps each on masked, collated batches of a synthetic
     corpus; launches of the training kernels per step (12 each of #5 and
     #6's two passes), finite losses, a bitwise repeat of one step, the step's time breakdown, and one step
     of the kernel path against the eager path at dropout 0;
  5. FFN kernels: the training FFN block's forward (#9) and backward (#10)
     against their plain versions (and #10 against autograd of the plain
     forward) at the training buckets' rows, rates 0.1 and 0, with times
     and bounds, #10 also at the edges of its tiles (rows 1 .. 129,
     F = 3072 and 384), each #10 call repeated bit for bit, #10 at the mix
     bucket's rows replayed from a CUDA graph, each of its kernels' device
     time from one profiled call, beside the autograd backward of the
     eager chain (F.linear, erf GELU, F.linear, dropout, + x, LayerNorm),
     #9 at the mix bucket's rows, rates 0.1 and 0, replayed from a CUDA
     graph beside #3 on the same rows, #9 at #3's tile edges (FFN_EDGES)
     at both rates, each call repeated bit for bit and at rate 0 bit for
     bit #3's, and #9's dropout mask against the plain Philox mask;
  6. long-L kernels: #4, #5 and #11, one streamed core, against their
     plain versions at the edges of its tiles (L = 1 .. 512, B = 3,
     fused-QKV views, rates 0.1 and 0), each call repeated bit for bit,
     #5 at rate 0 and #1 bitwise equal to #4; #6 and each of its passes against
     their plain versions at the same tails, repeated bit for bit; #4 at
     (B, L) = (16, 512), (4, 419), (4, 450) beside SDPA and its bound,
     replayed from a CUDA graph (its device time alone) and on the host's
     clock beside #1's wrapper; #1 at (64, 98), (64, 162), (56, 174),
     (24, 339) the same way; #5 and #6 (and each pass) against their
     plain versions at (56, 174), (24, 339) and (16, 512), rates 0.1 and
     0, timed beside SDPA as in phase 2, a bitwise repeat of #6, the mask
     at L = 512;
  7. mix: full-width uc2-base steps of the four tasks of
     config/uc2_pretrain.json (itm, mlm, vmlm in German, tlm with 'mix'
     co-masking) at L = 162, B = 128 under "pallas-train" with
     UC2_FFN_TRAIN=1, on batches from the port's datasets and collate over
     a synthetic pretraining corpus: 1 warm-up and 3 timed steps each,
     launches of #5, #6's two passes, #9 and #10 per step (12 each), a
     bitwise repeat of a vmlm step, itm and vmlm steps against the eager
     path at dropout 0, and the mlm step with and without the FFN kernels;
  8. long captions: full-width uc2-base mlm steps on captions of up to 410
     tokens, the three buckets of default_buckets(410, 100, 10240) (joint
     L = 174, 339, 512 at B = 56, 24, 16) interleaved as MetaLoader ->
     PrefetchLoader give them: under "pallas" at dropout 0.1, ms/step,
     examples/s and peak memory per bucket, 12 launches each of #5 and
     #6's two passes a step, finite losses, a bitwise repeat of
     an L = 512 step; then at dropout 0 one step per bucket (12 launches
     of #4 at L = 512, of #1 below) against the eager path, and the
     kernel path's ms/step there;
  9. route kernels: #7 against its plain version at (B, L) = (64, 128)
     and (64, 162), timed from CUDA graphs and on the host's clock beside
     the lab's v1chain (the cuBLAS QKV projection, then #2), and at #2's
     edges (clusters of up to 16 blocks), each call repeated bit for bit;
     #12 (and its row statistics) at (64, 128), (64, 162)
     and (16, 512) and at the edges of its key blocks and query tiles
     (first key blocks masked for whole rows), each call repeated bit for
     bit, timed (also from CUDA graphs) beside SDPA with a boolean segment
     mask on the padded tensors; #12a and #12b each against its plain version on the
     same inputs at (160, 128), (128, 162) and (16, 512) and at #12's
     edges (#12b repeated bit for bit there), #12a at its 64-key tile
     edges L = 129, 192, 200 and 255 in every mask case (DQ_EDGES), each
     repeated bit for bit, the three through autograd against the plain
     backward, a bitwise repeat, and their times (also from CUDA graphs)
     beside SDPA's autograd backward;
 10. routes: full-width uc2-base full_retrieval_eval over a gallery that
     gives each region-count bucket one batch of 64 images, with
     UC2_ATTN_V2=1 under "pallas" (12 launches of #7 a batch at L = 128
     and 162, none of #2; #1 at L = 98; #3 everywhere) and under "flash"
     (12 of #12 a batch at L = 128 and 162, no other kernel); one batch
     per bucket against the eager path, and ms/batch in turns beside the
     default route; then the L = 98 batch with UC2_FUSE_ATTN_ALL=1 (12
     launches of #2 a batch, of #7 with UC2_ATTN_V2=1, none of #1) against
     the eager path, and its ms/batch in turns beside the default route;
 11. flash train: full-width mlm steps under "flash" at attention
     dropout 0 (hidden dropout 0.1) at (B, L) = (160, 128), (128, 162)
     and the long phase's (16, 512) batch: 12 launches each of #12, #12a
     and #12b a step, finite losses, ms/step in turns beside "pallas" and
     "pallas-train", a bitwise repeat, one step against the eager path at
     dropout 0;
 12. lab kernels: #8 (the whole encoder layer) against its plain version
     at (B, L) = (64, 98), (64, 128), (64, 162) and (8, 512), #11 (attention
     with unnormalised bf16 probabilities) at (64, 98) and (64, 162) on
     heads that are views into one projection, each timed with its bound,
     chained and from CUDA graphs (#8 beside #2 + #3 on the same inputs,
     #11 beside SDPA), and repeated bit for bit;
 13. lab: uc2_torch.lab.main for each of its six modes (op, block, block2,
     ffn, layer, ce) at the lab's default shapes (B = 64, L = 162; the ce
     race at N = 1536, V = 250002) and --iters 10, its output echoed:
     every racer prints a RESULT line, none FAILED, each maxerr within
     the mode's limit (LAB_MAXERR), #8 launched only in layer and #11 only
     in op;
 14. pretrain: ``python -m uc2_torch.pretrain --config
     config/uc2_pretrain.json`` run in this process through its own parse
     (uc2-base at full width, the config's mix itm:mlm:vmlm:tlm, dropout
     0.1, bf16, 3 stacked micro-batches a step), after the embedding
     backward of the token types and the word table timed three ways
     (PyTorch's, indexing's, SmallTableLookup's) with bitwise repeats,
     on U2S stores that the
     port's synth_corpus writes under build/ at the reference's widths (en
     unpaired and de paired, 512 images x 2 captions each, 2048-d fp16
     features, 10-100 boxes, 1601 soft-label classes, vocab 250002): the
     stores' records/s and MB/s in DetectFeatDb.prefetch; 12 steps with a
     restore.ckpt every 6 and validation (2 batches a task) at 12, each
     step launching #5 and #6's two passes once a layer and micro-batch
     and each validation batch the gates' kernels (#2 + #3 at L >= 128,
     #1 + #3 below; also over a full validation sweep), finite losses,
     ms/step and examples/s of the loop, the seconds of each save; then
     the run stopped after step 6 and resumed to 12 in one directory,
     whose parameters, AdamW moments and per-step losses must equal the
     uninterrupted run's bit for bit; every record read by the native
     store library. The stores and checkpoints are deleted at the end;
 15. objectives: full-width uc2-base steps at the mix's bucket (62 text
     tokens, 100 regions, B = 128; tlm-ni text only at L = 62) of mmxlm,
     vmlm-soft, mmxlm-soft, mrfr, mrc, mrc-kl, mrm-nce, itm-ot at lambda
     0.1 (both OT reductions), itm on ItmHardNegDataset's batches and
     co-masked tlm-ni, from the port's datasets over an in-memory corpus,
     under "pallas-train" with UC2_FFN_TRAIN=1: 1 warm-up and 3 timed
     steps each (12 launches each of #5, #6a, #6b, #9, #10 a step, finite
     losses, median ms/step, peak memory), a deterministic eval_step
     launching the gates' kernels, a bitwise repeat of an mrm-nce and an
     itm-ot step, one step against the eager path at dropout 0
     (OBJ_LIMITS); IPOT alone at (128, 62, 100) on the host's clock, from
     a CUDA graph and its kernel count, and its share of the itm-ot step;
     then the driver on U2S stores of 128 images (en with a soft-label
     store, de paired): config/demo_pretrain.json's mix (itm, mlm, mrfr,
     mrc, tlm) and every other task with --itm_ot_lambda 0.1 --optim
     adamax --itm_hard_neg, each 12 steps with validation of every task
     (its keys logged) and again stopped at 6 and resumed, equal bit for
     bit (parameters, both moments, losses), #5/#6a/#6b 12 times a
     micro-batch. The stores and checkpoints are deleted at the end;
 16. itm: ``python -m uc2_torch.itm --config config/uc2_mscoco_itm.json``
     run in this process (uc2-base at full width, the config's four
     training pairs with the zh [train2014, val2014] routing pair, 13
     groups of 3 = 39 rows a micro-batch, 8 stacked micro-batches a step,
     dropout 0.1, bf16, eval_batch_size 300) on U2S stores that the port's
     synth_corpus writes under build/ at the reference's widths, from a
     checkpoint of the port's initialised weights; every override is
     printed: stopped after step 3 and resumed to 6 (validation, milestone
     and restore.ckpt at 3 and 6, the test pairs at the end), the resumed
     run loading step 3's parameters and AdamW moments bit for bit; then
     with --hard_neg_size 1 --hard_neg_steps 3 (sample size 5, 40 rows;
     5 steps and --eval_batch_size 64), its mining files before step 1
     and after step 3; launches: 96 each of #5,
     #6a and #6b a step and each scored batch the gates' kernels; #1, #2
     and #3 at B = 300 against their plain versions; ms/step, the loader's
     host time, scoring pairs/s at B = 300, mining seconds, peak memory; a
     rank step repeated bit for bit, timed alone and profiled, and one at
     dropout 0 through the kernel path against the eager fp32 path beside
     the eager bf16 path. The stores and checkpoints are deleted;
 17. finetune: ``python -m uc2_torch.vqa`` with its defaults
     (uc2-base at full width, batch 64, dropout 0.1, bf16, 3129 answers)
     but for its stores, 3 steps with validation (8 batches of 32), a
     milestone and restore.ckpt at 3, resumed to 6 (step 3's parameters
     and AdamW moments loaded bit for bit), then one validation alone;
     ``python -m uc2_torch.ve`` for 3 steps; ``python -m uc2_torch.nlvr2``
     (uniter-base, from an encoder checkpoint with two token types) in
     the triplet (32 rows at L = 262), paired and paired-attn (32 pairs,
     64 rows at L = 162) formats, 3 steps each with the --pred_csv sweep
     scored by ``python -m uc2_torch.eval_nlvr2`` (every identifier in
     the CSV, accuracy and consistency parsed), all in this process on
     U2S stores that the port writes under build/ (2048-d fp16 features,
     10-100 boxes; VQA targets among ans2label.json's answers, NLVR2
     image pairs and identifiers); launches: 12 each of #5, #6a, #6b a
     step, the gates' kernels a deterministic batch; ms/step, rows/s,
     peak memory, prediction rows/s; #2 and #3 at (32, 262) and (64, 162)
     with the batches' padding masks and #5/#6 at (32, 262), rates 0.1
     and 0, against their plain versions and timed; a VQA step repeated
     bit for bit, timed alone and profiled, and at dropout 0 through the
     kernel path against the eager fp32 path beside the eager bf16 path
     (the loss within VQA_LOSS_RTOL of fp32's). The stores are deleted;
 18. dist: data-parallel training across processes at uc2-base width
     under "pallas-train" with config/uc2_pretrain.json's task mix, on U2S
     stores written under build/ (the kernels are built before any
     process starts): #5, #6a and #6b against their plain versions at a
     process's rows (64, 162), rates 0.1 and 0; two NCCL processes on the
     one card refused at start, naming --dist_backend gloo; (a) ``python
     -m uc2_torch.pretrain --coordinator_address ... --num_processes 1
     --process_id 0 --zero1`` over NCCL for DIST_STEPS steps, its per-step
     losses, parameters and moments bit for bit those of the same run
     without a process group (in this process); (b) two processes on the
     card over gloo: which collectives gloo takes on CUDA tensors; one mlm
     step at dropout 0 on a (128, 162) batch split 2 x 64 against the same
     batch in one process (loss within STEP_LOSS_TOL and DIST_LOSS_RTOL,
     the masked-token count summed over the processes equal, grad norm
     within DIST_NORM_RTOL), with --zero1 the parameters bit for bit the
     replicated two-process step's, per-process ms/step and the
     collectives' ms a step; then the driver in two processes with
     --zero1, saved and stopped at DIST_STOP, resumed to DIST_STEPS: the
     restored step, model and optimizer bit for bit, both processes'
     stream files, the processes' dropout masks different (process 0's
     the one-process masks), launches of #5/#6a/#6b, ms/step a process.
     The stores and checkpoints are deleted;
 19. int8: int8 serving at uc2-base width: each of a layer's four int8
     products at (64, 98) rows on the card against its plain version (the
     codes and the int32 sums of cuBLASLt's ``_int_mm`` bit for bit the
     CPU's exact product, the output within INT8_RTOL), timed beside the
     bf16 ``F.linear``; int8 against bf16 scoring from the same weights
     at B = 64 and L = 98, 128, 162 (finite, max |diff|, rank correlation
     over INT8_TEXTS texts and the INT8_SEEDS weight draws held to
     INT8_RANK_RHO, 12 launches of #1 and 48 int8 products a batch and no
     fused block, ms/batch and implied TFLOP/s of both; the int8 function
     in fp32 on the card against the CPU's, code for code over
     INT8_CPU_ROWS pairs, each layer fed the card's input, within
     INT8_CODE_SHARE), one
     int8 batch traced through ``uc2_torch.utils.profiling.trace`` (#1's
     launches read from the trace); ``python -m uc2_torch.itm --quant
     int8`` for INT8_STEPS steps with validation and tests on phase 16's
     stores (launches, int8 products a scored batch, test_results.json);
 20. remat: the mlm step at (128, 162) under "pallas-train" at dropout
     0.1 with remat none, full and dots, without and with UC2_FFN_TRAIN=1:
     loss and every gradient of full and dots bit for bit none's, the
     dropout streams where none leaves them, launches (the recompute
     launches #5, and #9, again), ms/step, peak memory and implied
     TFLOP/s; then ``uc2_torch.import_lmdb`` on a fixture in the original
     release's LMDB format (``data/synth.py`` ``reference_lmdb``) and two
     mlm steps on the card from the imported stores;
 21. tp: tensor parallelism (``--n_model``): (a) #2's and #7's partial
     modes on each shard of T = 2 and 4 of the heads at (64, 128),
     (64, 162) and (32, 262) and at their tiles' edges (TP_EDGES), #3's on
     each shard of F / T = 1536 and 768 at (64, 98 / 128 / 162), #9's and
     #10's on each shard of F / T = 1536 and 768 at 20736 and 5184 rows,
     rates 0.1 and 0 (#9 at rate 0 without b2 bit for bit #3's partial
     mode), against their plain versions, repeated bit for bit and timed
     beside the whole kernel, and the partials summed (with the epilogue;
     #10's dx plus dy_pre, its weight gradients gathered) against the
     whole kernel; the int8 row-parallel product on T = 2 and 4 shards
     from the group's maxima, codes and int32 sums bit for bit the whole
     product's; #5 and #6a on each shard of T = 2 and 4 of the heads at
     (128, 162) and (16, 512), rate 0.1, with the head offset in their
     Philox key: output, dQ, row statistics and keep bits bit for bit
     those heads of the whole launch; (b) two processes on the card over
     gloo at --n_model 2, uc2-base: scores at B = 64, L = 98 / 128 / 162
     on the default route, with UC2_ATTN_V2=1 and under int8, each
     against one process's on the same weights (SCORE_TOL, then
     TP_SCORE_TOL), the launches (12 of #2's or #7's and #3's partial
     modes a batch where the gates open; int8: 12 of #1 on 6 heads and 48
     int8 products), ms/batch and the model group's all-reduces; the mlm
     step at (TP_STEP_B, 162), dropout 0.1, "pallas-train", without and
     with UC2_FFN_TRAIN=1 (#9's and #10's partial modes), against one
     process's (STEP_LOSS_TOL, STEP_NORM_RTOL), ms/step and the
     all-reduces a step; ``python -m uc2_torch.pretrain --n_model 2`` on
     phase 18's kind of stores, saved at TP_STOP and resumed to TP_STEPS
     bit for bit, restore.ckpt the whole model, the group's dropout masks
     the same; ``python -m uc2_torch.itm --quant int8 --n_model 2`` for
     TP_ITM_STEPS steps with validation and a test, test_results.json;
 22. runbook: ``python -m uc2_torch.make_demo_data`` under build/ (64
     images x 2 captions, 2048-d features, 10-100 boxes), its en stores
     re-encoded in the release's LMDB format (``data/synth.py``
     ``reference_lmdb``) and a uc2-base ``.pt`` under the release's key
     names without ``rank_output`` (the port's seed-0 init plus 0.02
     N(0, 1) from ``torch.manual_seed(0)``); ``python -m
     uc2_torch.verify_real_ckpt`` run twice in this process: at its
     defaults from the LMDB databases with --quant int8 (num_bb 36:
     L = 80, 98; the parity batch of 8 pairs against the fp32 oracle on
     the CPU within SCORE_TOL, the leaves loaded, the rank head from the
     ITM head, R@K finite in [0, 100] under bf16 and int8), then from the
     imported stores with --num_bb 100 --skip_torch (L = 98, 128, 162);
     each run's scored batches those of the buckets and its launches the
     routing's (#1 and #3, #2 at L >= 128, int8 #1 alone), ms/batch of
     each eval; then ``python -m uc2_torch.collate_bench --seconds 0.5``,
     four RESULT lines above 0 ex/s. The files are deleted;
 23. a JSON line of per-kernel numbers (launches: the main-path phases'
     counts, the pretraining driver's, the objectives', the itm driver's,
     the finetuning drivers', the distributed runs', the int8, the
     runbook, the remat and the tensor-parallel phases' added, the last
     read in its first process; #3's adds the routes phase and the lab),
     then the last line {"ok": true, "device": {...}}.
The phases run in the order 1, 2, 5, 6, 9, 12, 3, 10, 4, 7, 8, 11, 13, 14,
15, 16, 17, 18, 19, 22, 20, 21, 23.
Without a GPU it exits non-zero before printing any result.

`python3 chip_smoke.py --times [group ...]` runs phase 1 and then only
the timings of the named groups (all seven when none is named), no result
lines: "stream" #5, #6, #4 and #1 at the main path's shapes as phases 2
and 6 time them, "block" #2 and #7 as phases 2 and 9 do, "ffn" #9 and #3
and #10 (with its kernels' profile) as phase 5 does, "segment" #12, #12a
and #12b as phase 9 does, "layer" #8 and #2 + #3 as phase 12 does,
"step" phase 4's mlm step at L = 162, "embed" the embedding backwards
as phase 14 times them. A copy of
this script in another tree of the port (it calls only the kernels'
wrappers, whose signatures the port keeps, #1's C entry and the model's
entry points) times that tree's kernels and step, so an A/B of two trees
fits in one call.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from uc2_torch import (collate_bench, eval_nlvr2, import_lmdb, itm, lab,
                       make_demo_data, nlvr2, pretrain, ve, verify_real_ckpt,
                       vqa)
from uc2_torch.config import UC2Config
from uc2_torch.data import datasets, db, native_build
from uc2_torch.data.collate import BucketSpec, default_buckets
from uc2_torch.data.labels import LabelVocab, hash_tokenize
from uc2_torch.data.loader import (MetaLoader, PrefetchLoader, TaskLoader,
                                   task_batch_to_device)
from uc2_torch.data.memdb import (MemImgDb, MemTxtDb, synth_gallery,
                                  synth_pretrain_corpus)
from uc2_torch.data.store import READS as store_reads
from uc2_torch.data.synth import (reference_lmdb, synth_corpus,
                                  synth_finetune_texts)
from uc2_torch.evalu import retrieval
from uc2_torch.models import convert
from uc2_torch.models import heads as lm_heads
from uc2_torch.models.finetune import (UC2ForImageTextRetrieval, UC2ForNlvr2,
                                      UC2ForVqa)
from uc2_torch.models.convert import shard_tensor
from uc2_torch.models.encoder import SmallTableLookup, gelu
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import build
from uc2_torch.ops import int8 as int8_ops
from uc2_torch.ops.dropout import DropoutRng, dropout
from uc2_torch.ops.ffn_train import (
    _forward_to_stats, fused_ffn_block_train_bwd,
    fused_ffn_block_train_bwd_plain, fused_ffn_block_train_fwd,
    fused_ffn_block_train_partial_bwd, fused_ffn_block_train_partial_bwd_plain,
    fused_ffn_block_train_partial_fwd, fused_ffn_block_train_partial_plain,
    fused_ffn_block_train_plain)
from uc2_torch.ops.flash_attention import (
    flash_attention, flash_attention_long,
    flash_attention_long_plain, flash_attention_plain,
    flash_attention_train_bwd, flash_attention_train_bwd_dkdv,
    flash_attention_train_bwd_dkdv_plain, flash_attention_train_bwd_dq,
    flash_attention_train_bwd_dq_plain, flash_attention_train_bwd_plain,
    flash_attention_train_fwd, flash_attention_train_plain,
    flash_attention_v3, heads_row_stride, uses_long_kernel)
from uc2_torch.ops.attention import STOCK_FLASH_MIN_LEN
from uc2_torch.ops.fused_block import (block_epilogue, fused_attn_block,
                                       fused_attn_block_partial,
                                       fused_attn_block_partial_plain,
                                       fused_attn_block_plain,
                                       fused_attn_block_v2,
                                       fused_attn_block_v2_partial,
                                       fused_attn_block_v2_partial_plain,
                                       fused_attn_block_v2_plain,
                                       fused_block_profitable,
                                       fused_ffn_block,
                                       fused_ffn_block_partial,
                                       fused_ffn_block_partial_plain,
                                       fused_ffn_block_plain,
                                       fused_ffn_profitable,
                                       fused_layer_block,
                                       fused_layer_block_plain,
                                       layer_norm_f32)
from uc2_torch.ops.lab_attention import (attention_bf16_probs,
                                         attention_bf16_probs_plain)
from uc2_torch.ops.philox import ffn_keep_mask, keep_mask
from uc2_torch.ops.segment_flash import (
    padded_len, segment_flash_attention, segment_flash_bwd_dkdv,
    segment_flash_bwd_dkdv_plain, segment_flash_bwd_dq,
    segment_flash_bwd_dq_plain, segment_flash_fwd, segment_flash_plain)
from uc2_torch.training.optim import build_optimizer, constant, get_lr_schedule
from uc2_torch.training import checkpoint as itm_checkpoint
from uc2_torch.training import step as train_step_mod
from uc2_torch.training.step import make_loss_fn, train_step
from uc2_torch.utils import flops, profiling
from uc2_torch.utils.misc import set_dropout

# H100 SXM published peaks (dense bf16 tensor rate, HBM3 bandwidth)
PEAK_BF16_FLOPS, PEAK_BYTES = flops.H100_BF16_FLOPS, flops.H100_BYTES_PER_S
B, N, D, H, FF = 64, 12, 64, 768, 3072
TXT_LEN, NUM_BB = 62, 100
N_IMGS = 272
# kernel vs plain, both rounding to bf16 at the same points: the outputs
# are bf16, so allow two bf16 ulps of the value (2^-7 relative) plus 2e-2
# for LayerNorm-scaled outputs near zero whose fp32 sums differ in order
ATOL, RTOL = 2e-2, 2.0 ** -7
# rank scores after 12 bf16 layers, kernel path vs the eager bf16 path
SCORE_TOL = 5e-2
KERNELS = (flash_attention, fused_attn_block, fused_ffn_block)
# #5 and #6's two passes (#6 itself launches nothing: it is the two
# passes), 12 each a training step at every L
TRAIN_KERNELS = (flash_attention_train_fwd, flash_attention_train_bwd_dq,
                 flash_attention_train_bwd_dkdv)
FFN_KERNELS = (fused_ffn_block_train_fwd, fused_ffn_block_train_bwd)
LONG_KERNELS = (flash_attention_long,)
# #7 (UC2_ATTN_V2) and #12 / #12a / #12b ("flash")
ROUTE_KERNELS = (fused_attn_block_v2, segment_flash_fwd, segment_flash_bwd_dq,
                 segment_flash_bwd_dkdv)
SEGMENT_KERNELS = ROUTE_KERNELS[1:]
# #8 and #11, which only the kernel lab runs
LAB_KERNELS = (fused_layer_block, attention_bf16_probs)
# the partial modes of #2, #3, #7, #9 and #10 (tensor parallelism)
TP_KERNELS = (fused_attn_block_partial, fused_ffn_block_partial,
              fused_attn_block_v2_partial, fused_ffn_block_train_partial_fwd,
              fused_ffn_block_train_partial_bwd)
ALL_KERNELS = (KERNELS + TRAIN_KERNELS + FFN_KERNELS + LONG_KERNELS
               + ROUTE_KERNELS + LAB_KERNELS + TP_KERNELS)
# training buckets (B, regions), 62 text tokens, 24 prediction slots
# (bench.py TRAIN_BUCKETS and its M): joint L = 98, 128, 162
TRAIN_BUCKETS = ((208, 36), (160, 66), (128, 100))
TRAIN_TXT, TRAIN_SLOTS, TIMED_STEPS = 62, 24, 5
TRAIN_SEED = 1234
# one training step, kernel path vs eager path at dropout 0 from the same
# weights, 12 bf16 layers (H100 readings: loss 2.6e-4 apart, grad norm
# 5.4e-4 relative; limits about 5x that). The gradients of each layer's
# Q, K and V projection weights, which the attention backward's dq, dk and
# dv feed, are held block by block in relative norm to 2^-5, so a dq or dk
# wrong only in scale shows there before AdamW hides it.
# Adam's first update is ~lr * sign(g), so an update may differ by up to
# 2 lr where a gradient near 0 flips sign; at most 1% of the updates may
# differ by more than lr / 10
STEP_LOSS_TOL, STEP_NORM_RTOL, STEP_FLIP_SHARE = 1.3e-3, 2.7e-3, 1e-2
STEP_QKV_RTOL = 2.0 ** -5
FAILURES = []


def fail(msg: str):
    """Record a failed check; the run goes on and exits non-zero at the end."""
    print(f"chip_smoke: FAILED: {msg}")
    FAILURES.append(msg)


def fatal(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def reset_launches():
    for k in ALL_KERNELS:
        k.launches = 0


def launch_counts():
    return {k.__name__: k.launches for k in ALL_KERNELS}


def no_launches():
    """Every kernel's count at 0: the base of an expected count."""
    return {k.__name__: 0 for k in ALL_KERNELS}


time_ms = lab.time_ms      # CUDA events around chained calls, after a warm-up


def bound(nbytes: float, flops: float):
    """Least time (ms) for the work: bytes over HBM bandwidth or matmul
    operations over the bf16 tensor rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(out, ref):
    """(within two bf16 ulps + 2e-2 of the plain version, max error)."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= ATOL + RTOL * ref.abs()).all())
    return ok, err.max().item()


def held(what: str, out, ref, quiet: bool = False):
    """``close``'s (ok, max error); unless ``quiet``, printed, and recorded
    as a failure where the kernel disagrees."""
    ok, max_err = close(out, ref)
    if not quiet:
        print(f"  {what}: max|kernel - plain| = {max_err:.4e} "
              f"(max|plain| {ref.float().abs().max().item():.3e}; tolerance "
              f"2e-2 + 2^-7*|plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{what} disagrees with its plain version")
    return ok, max_err


def compare(what: str, out, ref) -> float:
    return held(what, out, ref)[1]


def heads(gen, b, L):
    """q, k, v as views into one [b, L, 3H] projection, as the encoder
    hands them over, and a padding bias keeping >= L/2 keys per row."""
    qkv = torch.randn(b, L, 3 * H, generator=gen, device="cuda").bfloat16()
    q, k, v = (t.view(b, L, N, D) for t in qkv.split(H, dim=-1))
    lens = torch.randint(L // 2, L + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(L, device="cuda")[None] < lens[:, None]).float()
    return q, k, v, ((1.0 - mask) * -10000.0)[:, None, None, :].contiguous()


def vec(gen, n, scale, offset=0.0):
    return torch.randn(n, generator=gen, device="cuda") * scale + offset


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fatal(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: "
          f"{name}, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for fp32 matmuls and convolutions (plain references run "
          "in full fp32)")
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s -> {path}")
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:   # the kernel, mangled
            print("  " + line.split("'")[1][:90])
        elif "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    return name, card


def ratios(ms, lib, lo) -> str:
    """kernel / library and kernel / bound, printed beside the times."""
    vs = "n/a" if lib is None else f"{ms / lib:.2f}"
    return f"kernel / library {vs}, kernel / bound {ms / lo:.1f}"


def graph_ms(fn, iters: int = 20, stream=None) -> float:
    """Mean ms per call of ``fn`` replayed from one CUDA graph of ``iters``
    calls: the device's time without the host's work between launches
    (the wrapper's checks, its C entry's set-up, the launch itself).
    ``stream``: the side stream to capture on (one call runs there first)."""
    graph = torch.cuda.CUDAGraph()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5) / iters


def host_ms(fn, iters: int = 200) -> float:
    """Mean ms of the host's clock per call of ``fn`` with the launches
    queued and not waited for: the host's work a call costs, where the
    device keeps up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def run_case(rows, name, b, L, kernel, plain, args, nbytes, flops,
             library=None, report=False, graph=False):
    """Hold one kernel call against its plain version, time both (and the
    library yardstick; with ``graph`` also the kernel and the library
    replayed from CUDA graphs, and each on the host's clock), and fold the
    numbers into the kernel's JSON row; the row's times are those of the
    case marked ``report``."""
    err = compare(f"{name} B={b} L={L}", kernel(*args), plain(*args))
    t = dict(ms=time_ms(lambda: kernel(*args)),
             plain_ms=time_ms(lambda: plain(*args)),
             library_ms=None if library is None else time_ms(library))
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops)
    lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
    print(f"    kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"library {lib} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
          f"; {ratios(t['ms'], t['library_ms'], t['bound_ms'])}")
    if graph:
        g_ms = graph_ms(lambda: kernel(*args))
        lib_g = None
        if library is not None:
            try:
                lib_g = graph_ms(library)
            except RuntimeError as e:
                print(f"    library: could not be captured in a CUDA graph: "
                      f"{str(e).splitlines()[0]}")
                torch.cuda.synchronize()
        g_vs = "n/a" if lib_g is None else f"{g_ms / lib_g:.2f}"
        lib_gs = "n/a" if lib_g is None else f"{lib_g:.4f}"
        lib_h = ("n/a" if library is None else f"{host_ms(library):.4f}")
        print(f"    from CUDA graphs: kernel {g_ms:.4f} ms, library {lib_gs} "
              f"ms (kernel / library {g_vs}, kernel / bound "
              f"{g_ms / t['bound_ms']:.1f}); host clock per call: kernel "
              f"{host_ms(lambda: kernel(*args)):.4f} ms, library {lib_h} ms")
    row = rows[name]
    row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
    if report:
        row.update(t)


def phase_kernels(gen):
    """Each kernel against its plain version at every shape the slice gives
    it; returns the JSON rows."""
    print("== kernels vs plain (plain: fp32 compute on the same bf16 inputs)")
    rows = {
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source="uc2_torch/csrc/attention_stream.cuh",
            replaces="uc2_tpu/ops/flash_attention.py:86"),
        "fused_attn_block": dict(
            name="fused_attn_block", route="cuda",
            source="uc2_torch/csrc/fused_attn_block.cu",
            replaces="uc2_tpu/ops/fused_block.py:37"),
        "fused_ffn_block": dict(
            name="fused_ffn_block", route="cuda",
            source="uc2_torch/csrc/fused_ffn_block.cu",
            replaces="uc2_tpu/ops/fused_block.py:251"),
    }
    # 1: attention forward at the L = 80 and 98 buckets (num_bb 36 and
    # 100), and at the 512 limit; yardstick: one
    # scaled_dot_product_attention call with the same mask
    for b, L in ((B, 80), (B, 98), (8, 512)):
        q, k, v, bias = heads(gen, b, L)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bias16 = bias.bfloat16()
        run_case(rows, "flash_attention", b, L, flash_attention_v3,
                 flash_attention_plain, (q, k, v, bias),
                 4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D,
                 library=lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=bias16),
                 report=L == 98)
    # 2: fused attention block at the L = 128 and L = 162 buckets, also
    # replayed from CUDA graphs, beside its eager chain; at L = 98 beside
    # that bucket's path (#1, the eager out-projection and LayerNorm); then
    # at the edges of its query tiles
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)
    time_blocks(rows, gen, (wo, bo, gamma, beta), report=True)
    attn_block_edges(rows, gen, (wo, bo, gamma, beta))
    # 3: fused FFN block at the L = 80 bucket (num_bb 36) and all three
    # of num_bb 100, also replayed from CUDA graphs, beside its two
    # products alone; then at the edges of its row tiles and waves, and at
    # F = 128
    w1 = (torch.randn(FF, H, generator=gen, device="cuda") * 0.05).bfloat16()
    w2 = (torch.randn(H, FF, generator=gen, device="cuda") * 0.05).bfloat16()
    b1, b2 = vec(gen, FF, 0.02), vec(gen, H, 0.02)
    for L in (80, 98, 128, 162):
        x = torch.randn(B, L, H, generator=gen, device="cuda").bfloat16()
        args = (x, w1, b1, w2, b2, gamma, beta)
        run_case(rows, "fused_ffn_block", B, L, fused_ffn_block,
                 fused_ffn_block_plain, args,
                 2 * B * L * H * 2 + 2 * H * FF * 2 + (FF + 3 * H) * 4,
                 4 * B * L * H * FF, report=L == 162, graph=True)
        ffn_yardsticks(L, args)
    for n_rows, Fi in FFN_EDGES:
        w1e, w2e = w1[:Fi].contiguous(), w2[:, :Fi].contiguous()
        x = torch.randn(n_rows, H, generator=gen, device="cuda").bfloat16()
        args = (x, w1e, b1[:Fi].contiguous(), w2e, b2, gamma, beta)
        out = fused_ffn_block(*args)
        err = compare(f"fused_ffn_block rows={n_rows} F={Fi}", out,
                      fused_ffn_block_plain(*args))
        row = rows["fused_ffn_block"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        repeat_bitwise(f"#3 rows={n_rows} F={Fi}",
                       lambda: fused_ffn_block(*args), out)
    return rows


# #2's and #7's joint lengths at the edges of their 64-row query tiles (and
# of #7's clusters: 2 ceil(L / 64) blocks, above eight from L = 257), at
# B = 1, 2, 3 in turn, and one grid past a whole wave of 132 SMs (67 tiles
# of two blocks)
BLOCK_EDGES = ([(1 + i % 3, L) for i, L in enumerate(
    (1, 63, 64, 65, 127, 128, 129, 162, 192, 193, 257, 448, 512))]
    + [(67, 128)])
BLOCK_SHAPES = ((B, 128), (B, 162))     # the fused buckets of the slice
# calls past a whole wave repeat this often: blocks then start at other
# times relative to each other, which shows a race that one repeat misses
REPEATS_PAST_A_WAVE = 10


def block_bytes_flops(b, L):
    """#2's bound inputs: q, k, v and x read, the output written (bf16),
    the bias, Wo and the vectors; attention and the out-projection."""
    return (5 * b * L * H * 2 + b * L * 4 + H * H * 2 + 3 * H * 4,
            4 * b * N * L * L * D + 2 * b * L * H * H)


def v2_bytes_flops(b, L):
    """#7's: x read and the output written, the weights and vectors; the
    projection, attention and the out-projection."""
    return (2 * b * L * H * 2 + 4 * H * H * 2 + (6 * H + L * b) * 4,
            2 * b * L * H * 4 * H + 4 * b * N * L * L * D)


def yardstick(what, fn):
    """A chain of PyTorch calls beside a kernel (no single call computes
    its function): chained and replayed from a CUDA graph."""
    print(f"    yardstick, a chain of calls ({what}): {time_ms(fn):.4f} ms, "
          f"from a graph {graph_ms(fn):.4f} ms")


def eager_block_chain(q, k, v, bias, x, wo, bo, gamma, beta, attention):
    """#2's function as the eager path computes it: ``attention`` on the
    heads, then the out-projection, + x and LayerNorm as the encoder's
    Dense and LayerNorm (fp32 statistics) run them."""
    b, L = x.shape[:2]
    ctx = attention(q, k, v, bias).reshape(b, L, H)
    y = (F.linear(ctx, wo, bo.to(wo.dtype)) + x).float()
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    return ((y - mu) * torch.rsqrt(var + 1e-12) * gamma + beta).to(x.dtype)


def sdpa_heads(q, k, v, bias):
    """SDPA on [B, L, n, d] heads, its context back as [B, L, n, d]."""
    return F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)),
        attn_mask=bias.to(q.dtype)).transpose(1, 2)


def time_blocks(rows, gen, vecs, report=False):
    """#2 at the fused buckets (B = 64, L = 128, 162) against its plain
    version, timed chained, replayed from CUDA graphs and on the host's
    clock, beside its eager chain with SDPA; at (64, 98), where the slice
    runs #1 and the eager out-projection and LayerNorm instead (the gate
    fused_block_profitable is the reference's), beside that chain."""
    wo, bo, gamma, beta = vecs
    for b, L in BLOCK_SHAPES + ((B, 98),):
        q, k, v, bias = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        args = (q, k, v, bias, x, wo, bo, gamma, beta)
        run_case(rows, "fused_attn_block", b, L, fused_attn_block,
                 fused_attn_block_plain, args, *block_bytes_flops(b, L),
                 report=report and L == 162, graph=True)
        yardstick("SDPA on the heads + F.linear + residual + LayerNorm",
                  lambda: eager_block_chain(*args, sdpa_heads))
        if L == 98:
            yardstick("the slice's path at L = 98: #1 + F.linear + residual "
                      "+ LayerNorm", lambda: eager_block_chain(
                          *args, flash_attention_v3))


def attn_block_edges(rows, gen, vecs):
    """#2 at BLOCK_EDGES on views into one projection, and on contiguous
    heads at four of them, against its plain version, each call repeated
    bit for bit."""
    wo, bo, gamma, beta = vecs
    cases = [(b, L, True) for b, L in BLOCK_EDGES] + [
        (2, L, False) for L in (63, 65, 162, 512)]
    for b, L, strided in cases:
        q, k, v, bias = heads(gen, b, L)
        if not strided:
            q, k, v = (t.contiguous() for t in (q, k, v))
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        args = (q, k, v, bias, x, wo, bo, gamma, beta)
        out = fused_attn_block(*args)
        tag = f"B={b} L={L} {'views' if strided else 'contiguous'}"
        err = compare(f"fused_attn_block {tag}", out,
                      fused_attn_block_plain(*args))
        row = rows["fused_attn_block"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        repeat_bitwise(f"#2 {tag}", lambda: fused_attn_block(*args), out,
                       times=REPEATS_PAST_A_WAVE if b > 3 else 1)


def v2_weights(gen):
    w = lambda *shape: (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.05).bfloat16()
    wqkv, bqkv, wo = w(3 * H, H), vec(gen, 3 * H, 0.05), w(H, H)
    return (wqkv, bqkv, wo, vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0),
            vec(gen, H, 0.1))


def time_v2(rows, gen, weights, report=False):
    """#7 at the fused buckets against its plain version, timed chained,
    replayed from CUDA graphs and on the host's clock, beside the lab's
    v1chain (the cuBLAS QKV projection, then #2)."""
    wqkv, bqkv, wo, bo, gamma, beta = weights
    for b, L in BLOCK_SHAPES:
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        bias = heads(gen, b, L)[3]
        args = (x, wqkv, bqkv, bias, wo, bo, gamma, beta, N)
        run_case(rows, "fused_attn_block_v2", b, L, fused_attn_block_v2,
                 fused_attn_block_v2_plain, args, *v2_bytes_flops(b, L),
                 report=report and L == 162, graph=True)

        def v1chain():
            qkv = ((x @ wqkv.t()).float() + bqkv).to(x.dtype)
            q, k, v = (t.view(b, L, N, D) for t in qkv.split(H, dim=-1))
            return fused_attn_block(q, k, v, bias, x, wo, bo, gamma, beta)
        yardstick("v1chain: the cuBLAS QKV projection + #2", v1chain)


def v2_edges(rows, gen, weights):
    """#7 at BLOCK_EDGES against its plain version, each call repeated
    bit for bit."""
    wqkv, bqkv, wo, bo, gamma, beta = weights
    for b, L in BLOCK_EDGES:
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        args = (x, wqkv, bqkv, heads(gen, b, L)[3], wo, bo, gamma, beta, N)
        out = fused_attn_block_v2(*args)
        err = compare(f"fused_attn_block_v2 B={b} L={L}", out,
                      fused_attn_block_v2_plain(*args))
        row = rows["fused_attn_block_v2"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        repeat_bitwise(f"#7 B={b} L={L}", lambda: fused_attn_block_v2(*args),
                       out, times=REPEATS_PAST_A_WAVE if b > 3 else 1)


def phase_block_times(gen):
    """``--times``: #2 and #7 at the fused buckets (and #2 at L = 98), timed
    as phases 2 and 9 time them, through their wrappers."""
    rows = {k: dict(name=k) for k in ("fused_attn_block",
                                      "fused_attn_block_v2")}
    time_blocks(rows, gen, (
        (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16(),
        vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)))
    time_v2(rows, gen, v2_weights(gen))


# #3's row counts at the edges of its 64-row tiles and one past a whole
# wave (66 tiles of two blocks on 132 SMs; and 132 tiles), and an
# intermediate width of 128
FFN_EDGES = ((1, FF), (63, FF), (64, FF), (65, FF), (129, FF),
             (64 * 66 + 1, FF), (64 * 132 + 1, FF), (129, 128))


def ffn_yardsticks(L, args):
    """Beside #3 at (B, L): its two products alone as cuBLAS bf16 calls
    (x @ w1.t(), then h @ w2.t() on a precomputed bf16 h, no epilogue),
    chained and replayed from a CUDA graph, and the bytes #3's blocks take
    in from L2 (every 64-row tile reads all the weights once)."""
    x, w1, b1, w2 = args[:4]
    x2 = x.view(-1, H)
    h = F.gelu(x2 @ w1.t() + b1).bfloat16()
    products = lambda: (x2 @ w1.t(), h @ w2.t())
    l2 = -(-x2.shape[0] // 64) * 2 * H * w1.shape[0] * 2
    print(f"    two products alone (cuBLAS bf16): {time_ms(products):.4f} ms, "
          f"from a graph {graph_ms(products):.4f} ms; #3's weight bytes "
          f"from L2 a call: {l2 / 1e9:.3f} GB")


def bucket_batch(img_db, img_ids, txt_db, txt_id, nb):
    """The first scored batch of a bucket, as score_matrix builds it: one
    text against up to B images padded to nb regions (and to B rows)."""
    feats, bb7, nbbs = retrieval.load_image_gallery(img_db, img_ids[:B], nb)
    n = len(nbbs)
    f = torch.zeros(B, nb, feats.shape[2])
    b7 = torch.zeros(B, nb, 7)
    f[:n], b7[:n] = torch.from_numpy(feats), torch.from_numpy(bb7)
    rmask = torch.zeros(B, nb, dtype=torch.long)
    rmask[:n] = torch.from_numpy(np.arange(nb)[None] < nbbs[:, None]).long()
    ids = np.asarray(txt_db.combine_inputs(
        txt_db[txt_id]["input_ids"]))[:TXT_LEN]
    row = torch.ones(TXT_LEN, dtype=torch.long)          # pad id 1
    row[:len(ids)] = torch.from_numpy(ids)
    tmask = torch.zeros(TXT_LEN, dtype=torch.long)
    tmask[:len(ids)] = 1
    batch = {"input_ids": row.expand(B, TXT_LEN),
             "img_feat": f, "img_pos_feat": b7,
             "attn_mask": torch.cat([tmask.expand(B, TXT_LEN), rmask], 1)}
    return {k: t.cuda() for k, t in batch.items()}, n


def bucket_batches(n_txt, nbbs, num_bb=NUM_BB):
    """One ``full_retrieval_eval``'s region-count buckets: their edges, the
    images in each, and its scored batches (every one of ``n_txt`` texts
    against each bucket's tiles of B images)."""
    edges = retrieval.bucket_edges(TXT_LEN, num_bb)
    per_bucket = np.bincount(
        np.searchsorted(edges, np.minimum(nbbs, num_bb)),
        minlength=len(edges))
    return edges, per_bucket, [n_txt * -(-int(c) // B) for c in per_bucket]


def phase_slice(card):
    print("== slice: uc2-base full_retrieval_eval on the card")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention=True)
    t0 = time.perf_counter()
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    txt_db, img_db = synth_gallery(seed=0, n_imgs=N_IMGS, txt_per_img=1,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    print(f"  model ({sum(p.numel() for p in model.parameters())} params) and "
          f"gallery ({N_IMGS} images, {len(txt_db.ids)} texts) ready in "
          f"{time.perf_counter() - t0:.1f} s")

    # launches the routing predicts: 12 layers per scored batch
    n_txt = len(txt_db.ids)
    edges, per_bucket, batches = bucket_batches(
        n_txt, list(img_db.name2nbb.values()))
    if (per_bucket < B).any():
        fatal(f"a bucket holds fewer than {B} images: {per_bucket}")
    L_of = [TXT_LEN + e for e in edges]
    layers = cfg.num_hidden_layers
    expect = no_launches()
    expect.update({
        "flash_attention": layers * sum(
            nb for nb, L in zip(batches, L_of)
            if not fused_block_profitable(L, N)),
        "fused_attn_block": layers * sum(
            nb for nb, L in zip(batches, L_of)
            if fused_block_profitable(L, N)),
        "fused_ffn_block": layers * sum(
            nb for nb, L in zip(batches, L_of) if fused_ffn_profitable(L)),
    })

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, (m, txt_ids, img_ids) = retrieval.full_retrieval_eval(
        model, txt_db, img_db, TXT_LEN, NUM_BB, batch_size=B,
        return_matrix=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(f"  buckets (L={L_of}): {per_bucket.tolist()} images, "
          f"{batches} scored batches of {B}")
    print(f"  launches {launches}, expected {expect}")
    if launches != expect:
        fail("launch counts do not match the routing")
    if m.shape != (n_txt, N_IMGS) or not np.isfinite(m).all():
        fail(f"score matrix is {m.shape} or not finite")
    print(f"  R@K {json.dumps(metrics)}")
    print(f"  eval wall {wall:.2f} s for {sum(batches)} batches "
          f"({sum(batches) * B / wall:.1f} padded pairs/s, "
          f"{n_txt * N_IMGS / wall:.1f} gallery pairs/s) [{card}]")

    # one batch per bucket: kernel path vs the eager path on the card
    plain = UC2ForImageTextRetrieval(
        cfg.replace(use_pallas_attention=False), device="cuda")
    plain.load_state_dict(model.state_dict())
    ref32 = UC2ForImageTextRetrieval(
        cfg.replace(use_pallas_attention=False, dtype="float32"),
        device="cuda")
    ref32.load_state_dict(model.state_dict())
    col = {im: j for j, im in enumerate(img_ids)}
    bucket_of = np.searchsorted(edges, [img_db.name2nbb[i] for i in img_ids])
    for bi, nb in enumerate(edges):
        ids_b = [im for im, bk in zip(img_ids, bucket_of) if bk == bi]
        batch, n = bucket_batch(img_db, ids_b, txt_db, txt_ids[0], nb)
        s_k, s_p, s_32 = (mod.scores(batch)[:n] for mod in (model, plain,
                                                             ref32))
        in_matrix = torch.from_numpy(m[0, [col[i] for i in ids_b[:n]]])
        d_kp = (s_k - s_p).abs().max().item()
        d_mat = (s_k.cpu() - in_matrix).abs().max().item()
        print(f"  L={TXT_LEN + nb}: |kernel - eager bf16| {d_kp:.4e}, "
              f"|kernel - eager fp32| {(s_k - s_32).abs().max().item():.4e}, "
              f"|eager bf16 - eager fp32| "
              f"{(s_p - s_32).abs().max().item():.4e}, "
              f"|batch - matrix| {d_mat:.4e} (tolerance {SCORE_TOL})")
        if not (d_kp <= SCORE_TOL and d_mat <= SCORE_TOL):
            fail(f"scores at L={TXT_LEN + nb} disagree")
        ms_k = time_ms(lambda: model.scores(batch), iters=10)
        ms_p = time_ms(lambda: plain.scores(batch), iters=10)
        print(f"  L={TXT_LEN + nb}: kernel path {ms_k:.3f} ms/batch = "
              f"{B / ms_k * 1e3:.1f} pairs/s; eager bf16 {ms_p:.3f} ms/batch "
              f"= {B / ms_p * 1e3:.1f} pairs/s [{card}]")
        if TXT_LEN + nb in (98, 162):
            profile_scores(model, batch, TXT_LEN + nb, card)
    return {k.__name__: launches[k.__name__] for k in KERNELS}


TRAIN_ROWS = {
    "flash_attention_train_fwd": dict(
        name="flash_attention_train_fwd", route="cuda",
        source="uc2_torch/csrc/attention_stream.cuh",
        replaces="uc2_tpu/ops/flash_attention.py:289"),
    "flash_attention_train_bwd_dq": dict(
        name="flash_attention_train_bwd_dq", route="cuda",
        source="uc2_torch/csrc/attention_train.cu",
        replaces="uc2_tpu/ops/flash_attention.py:311"),
    "flash_attention_train_bwd_dkdv": dict(
        name="flash_attention_train_bwd_dkdv", route="cuda",
        source="uc2_torch/csrc/attention_train.cu",
        replaces="uc2_tpu/ops/flash_attention.py:311"),
}
STATS = ("row max", "1 / row sum", "D")


def compare_norm(what: str, out, ref, rtol: float) -> float:
    """||out - ref|| / ||ref|| <= rtol; returns max|out - ref|."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    rel = ((out - ref).norm() / ref.norm()).item()
    ok = bool(torch.isfinite(out).all()) and rel <= rtol
    print(f"  {what}: ||kernel - ref|| / ||ref|| = {rel:.3e} (max|kernel - "
          f"ref| {(out - ref).abs().max().item():.3e}, max|ref| "
          f"{ref.abs().max().item():.3e}; tolerance {rtol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what} disagrees")
    return (out - ref).abs().max().item()


def plain_autograd(q, k, v, bias, rate, g):
    """dq, dk, dv, dbias by autograd through the plain forward."""
    ins = [t.detach().requires_grad_(True) for t in (q, k, v, bias)]
    out = flash_attention_train_plain(*ins, TRAIN_SEED, rate)
    return torch.autograd.grad(out, ins, g)


def library_train_ms(q, k, v, bias, g, rate, graph=False):
    """Yardstick: scaled_dot_product_attention with the same mask and
    dropout (its own RNG), forward, and its autograd backward against
    ``g`` (None: the forward only); with ``graph`` also that backward
    replayed from a CUDA graph (None, with the reason printed, where it
    cannot be captured). Returns (forward ms, backward ms, graph ms)."""
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    bias16 = bias.bfloat16()

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias16,
                                              dropout_p=rate)
    try:
        fwd_ms = time_ms(fwd)
        if g is None:
            return fwd_ms, None, None
        # the forward on a side stream, so that its backward (which the
        # autograd engine runs on the forward's stream) can be captured
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fwd()
        torch.cuda.current_stream().wait_stream(side)
        gt = g.transpose(1, 2)

        def bwd():
            return torch.autograd.grad(out, (qt, kt, vt), gt,
                                       retain_graph=True)
        bwd_ms = time_ms(bwd)
    except RuntimeError as e:      # no backend takes this mask and dropout
        print(f"    library: scaled_dot_product_attention refused: {e}")
        return None, None, None
    bwd_graph = None
    if graph:
        try:
            bwd_graph = graph_ms(bwd, stream=side)
        except RuntimeError as e:
            print(f"    library: SDPA's autograd backward could not be "
                  f"captured in a CUDA graph: {str(e).splitlines()[0]}")
            torch.cuda.synchronize()
    return fwd_ms, bwd_ms, bwd_graph


def time_fwd(tag, q, k, v, bias, rate):
    """Time #5 on these inputs once, beside SDPA (``library_train_ms``)
    and the bound, and print kernel / SDPA and kernel / bound; returns
    (kernel ms, SDPA forward ms)."""
    b, L = q.shape[:2]
    args = (q, k, v, bias, TRAIN_SEED, rate)
    ms = time_ms(lambda: flash_attention_train_fwd(*args))
    lib_f, _, _ = library_train_ms(q, k, v, bias, None, rate)
    lo, by = bound(4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D)
    lib = "n/a" if lib_f is None else f"{lib_f:.4f}"
    print(f"    #5 {tag}: kernel {ms:.4f} ms, SDPA forward {lib} ms, bound "
          f"{lo:.4f} ms ({by}); {ratios(ms, lib_f, lo)}")
    return ms, lib_f


def bwd_bytes_flops(b, L):
    """#6's bound inputs: q, k, v and g read, dq, dk, dv written (bf16),
    the bias read and the per-head dbias partials written (fp32); the
    function's five products."""
    return (7 * b * L * H * 2 + b * L * 4 + b * N * L * 4,
            10 * b * N * L * L * D)


def time_bwd(tag, q, k, v, bias, g, rate):
    """Time #6 on these inputs chained and replayed from a CUDA graph,
    beside SDPA's autograd backward (chained and from a graph) and the
    bound, and print the ratios; returns (kernel ms, SDPA backward ms)."""
    b, L = q.shape[:2]
    args = (q, k, v, bias, TRAIN_SEED, rate)
    ms = time_ms(lambda: flash_attention_train_bwd(*args, g))
    g_ms = graph_ms(lambda: flash_attention_train_bwd(*args, g))
    _, lib_b, lib_g = library_train_ms(q, k, v, bias, g, rate, graph=True)
    lo, by = bound(*bwd_bytes_flops(b, L))
    lib = "n/a" if lib_b is None else f"{lib_b:.4f}"
    lib_gs = "n/a" if lib_g is None else f"{lib_g:.4f}"
    g_vs = "n/a" if lib_g is None else f"{g_ms / lib_g:.2f}"
    print(f"    #6 {tag}: kernel {ms:.4f} ms (graph {g_ms:.4f}), SDPA "
          f"autograd backward {lib} ms (graph {lib_gs}), bound {lo:.4f} ms "
          f"({by}); {ratios(ms, lib_b, lo)}; from graphs: kernel / library "
          f"{g_vs}, kernel / bound {g_ms / lo:.1f}")
    return ms, lib_b


def fold_err(rows, name, err):
    rows[name]["max_abs_err"] = max(rows[name].get("max_abs_err", 0.0), err)


def check_passes(tag, q, k, v, bias, seed, rate, g, rows, quiet=False):
    """#6's two passes, each against its plain version on the same inputs:
    pass 1's dq and row statistics, and its keep bits bit for bit; pass 2's
    dk, dv and dbias partials from the plain pass 1's statistics and bits;
    each pass called again for a bitwise repeat. Folds the errors into the
    passes' rows; unless ``quiet``, prints each check and records its
    failure. Returns pass 1's plain (statistics, bits) and the results:
    (ok, max error) of each pass, whether the bits agree, whether both
    passes repeat bit for bit."""
    args = (q, k, v, bias, seed, rate)
    dq, st, bits = flash_attention_train_bwd_dq(*args, g)
    pdq, pst, pbits = flash_attention_train_bwd_dq_plain(*args, g)
    r1 = [held(f"#6 pass 1 dq {tag}", dq, pdq, quiet)] + [
        held(f"#6 pass 1 {nm} {tag}", st[i], pst[i], quiet)
        for i, nm in enumerate(STATS)]
    if rate == 0.0:
        ok_bits = bits is None and pbits is None
    else:
        ok_bits = bits is not None and torch.equal(bits, pbits)
    part = flash_attention_train_bwd_dkdv(*args, g, pst, pbits)
    want = flash_attention_train_bwd_dkdv_plain(*args, g, pst, pbits)
    r2 = [held(f"#6 pass 2 {nm} {tag}", a, w, quiet) for nm, a, w in
          zip(("dk", "dv", "dbias partials"), part, want)]
    again = (*flash_attention_train_bwd_dq(*args, g),
             *flash_attention_train_bwd_dkdv(*args, g, pst, pbits))
    same = all(x is y or torch.equal(x, y)
               for x, y in zip((dq, st, bits, *part), again))
    if not quiet:
        print(f"  #6 pass 1 keep bits {tag}: == plain Philox bits bit for "
              f"bit (none at rate 0): {ok_bits}; both passes repeat "
              f"bitwise: {same}")
        if not ok_bits:
            fail(f"#6 pass 1's keep bits at {tag} are not the plain ones")
        if not same:
            fail(f"#6's passes at {tag} are not bitwise repeatable")
    res = {}
    for name, r in (("flash_attention_train_bwd_dq", r1),
                    ("flash_attention_train_bwd_dkdv", r2)):
        res[name] = (all(ok for ok, _ in r), max(e for _, e in r))
        fold_err(rows, name, res[name][1])
    return pst, pbits, res, ok_bits, same


def time_passes(tag, q, k, v, bias, g, rate, rows, pst, pbits):
    """Each pass of #6 timed with its plain version and bound into its
    row (no single PyTorch call computes a pass)."""
    b, L = q.shape[:2]
    args = (q, k, v, bias, TRAIN_SEED, rate)
    act, stat = b * L * H * 2, 3 * b * N * L * 4
    Lp = -(-L // 64) * 64
    bits = b * N * Lp * Lp // 8 if rate > 0.0 else 0
    for row, kern, plain, nbytes, flops in (
            (rows["flash_attention_train_bwd_dq"],
             lambda: flash_attention_train_bwd_dq(*args, g),
             lambda: flash_attention_train_bwd_dq_plain(*args, g),
             5 * act + b * L * 4 + stat + bits, 6 * b * N * L * L * D),
            (rows["flash_attention_train_bwd_dkdv"],
             lambda: flash_attention_train_bwd_dkdv(*args, g, pst, pbits),
             lambda: flash_attention_train_bwd_dkdv_plain(*args, g, pst,
                                                          pbits),
             6 * act + b * L * 4 + stat + b * N * L * 4 + bits,
             8 * b * N * L * L * D)):
        row.update(ms=time_ms(kern), plain_ms=time_ms(plain, iters=5),
                   library_ms=None)
        row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
        print(f"    {row['name']} {tag}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library none (no single PyTorch "
              f"call computes a pass), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")


def train_attention_case(tag, q, k, v, bias, g, rate, rows):
    """#5 and #6 on one input against their plain versions, #6 also
    against autograd of the plain forward and for a bitwise repeat, and
    each pass of #6 against its own (``check_passes``); folds the errors
    into the rows; returns pass 1's plain (statistics, bits)."""
    args = (q, k, v, bias, TRAIN_SEED, rate)
    names = ("dq", "dk", "dv", "dbias")
    ef = compare(f"#5 {tag}", flash_attention_train_fwd(*args),
                 flash_attention_train_plain(*args))
    got = flash_attention_train_bwd(*args, g)
    eb = [compare(f"#6 {nm} {tag}", a, w) for nm, a, w in zip(
        names, got, flash_attention_train_bwd_plain(*args, g))]
    # autograd of the plain forward rounds the gradient of its bf16
    # probabilities to bf16 (2^-9 relative), which the kernel and the
    # reference's formula do not; dbias sums n * L such terms, so it is
    # held in norm to 2^-7 there
    auto = plain_autograd(q, k, v, bias, rate, g)
    for nm, a, w in zip(names[:3], got, auto):
        compare(f"#6 {nm} vs autograd of plain fwd {tag}", a, w)
    compare_norm(f"#6 dbias vs autograd of plain fwd {tag}", got[3], auto[3],
                 2.0 ** -7)
    again = flash_attention_train_bwd(*args, g)
    same = all(torch.equal(a, w) for a, w in zip(got, again))
    print(f"  #6 {tag}: two calls bitwise equal: {same}")
    if not same:
        fail(f"#6 at {tag} is not bitwise repeatable")
    fold_err(rows, "flash_attention_train_fwd", ef)
    # #6's dq is pass 1's, its dk, dv and dbias pass 2's
    fold_err(rows, "flash_attention_train_bwd_dq", eb[0])
    fold_err(rows, "flash_attention_train_bwd_dkdv", max(eb[1:]))
    return check_passes(tag, *args, g, rows)[:2]


def phase_train_kernels(gen):
    """``train_attention_case`` at the training shapes, rates 0.1 and 0;
    #5 and #6 timed beside SDPA at each shape at rate 0.1 (#6 also from a
    CUDA graph); the rows' times are those of B = 128, L = 162, rate 0.1."""
    print("== training attention kernels vs plain (#5 forward, #6 backward "
          "and its two passes; plain: fp32 compute on the same bf16 inputs)")
    rows = {k: dict(v) for k, v in TRAIN_ROWS.items()}
    for b, L in ((208, 98), (160, 128), (128, 162)):
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            tag = f"B={b} L={L} rate={rate}"
            pst, pbits = train_attention_case(tag, q, k, v, bias, g, rate,
                                              rows)
            if rate == 0.0:
                if (b, L) == (128, 162):  # the passes without Philox's work
                    time_passes(tag, q, k, v, bias, g, rate,
                                {name: dict(row) for name, row
                                 in TRAIN_ROWS.items()},
                                pst, pbits)
                continue
            fwd_ms, lib_f = time_fwd(tag, q, k, v, bias, rate)
            bwd_ms, _ = time_bwd(tag, q, k, v, bias, g, rate)
            if (b, L) != (128, 162):
                continue
            args = (q, k, v, bias, TRAIN_SEED, rate)
            row = rows["flash_attention_train_fwd"]
            row.update(ms=fwd_ms, library_ms=lib_f, plain_ms=time_ms(
                lambda: flash_attention_train_plain(*args), iters=5))
            row["bound_ms"], row["bound_by"] = bound(
                4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D)
            lib_s = "n/a" if lib_f is None else f"{lib_f:.4f}"
            print(f"    {row['name']} {tag}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, library {lib_s} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            # #6 is its two passes: timed whole beside SDPA above, each
            # pass in its own row below
            plain6 = time_ms(lambda: flash_attention_train_bwd_plain(*args, g),
                             iters=5)
            print(f"    #6 {tag}: kernel {bwd_ms:.4f} ms, plain {plain6:.4f} "
                  f"ms")
            time_passes(tag, q, k, v, bias, g, rate, rows, pst, pbits)
    # the mask, exactly: q = k = 0, bias 0, v = I makes the output the
    # dropped, rescaled probabilities (L = d = 64, rate 0.5)
    L, rate = 64, 0.5
    z = torch.zeros(1, L, 1, D, device="cuda").bfloat16()
    eye = torch.eye(L, device="cuda").bfloat16().reshape(1, L, 1, D)
    out = flash_attention_train_fwd(z, z, eye, torch.zeros(1, 1, 1, L,
                                                           device="cuda"),
                                    TRAIN_SEED, rate)[0, :, 0, :]
    keep = keep_mask(TRAIN_SEED, rate, 1, 1, L, L, "cuda")[0, 0]
    same = torch.equal(out != 0, keep) and bool((out[keep] == 2.0 / L).all())
    print(f"  mask check (L = d = 64, rate 0.5): kernel zeros == plain "
          f"Philox mask bit for bit: {same} (kept share "
          f"{keep.float().mean().item():.4f})")
    if not same:
        fail("the training kernel's dropout mask is not the Philox mask")
    return rows


def on_card(batch):
    return {k: torch.from_numpy(a).to("cuda") for k, a in batch.items()}


def mlm_batches(txt_db, img_db, lo, Nb, B, n, seed):
    """``n`` mlm batches (MlmDataset, collate_batch) of the captions whose
    images have (lo, Nb] regions, collated to (62 text tokens, Nb regions,
    B rows, 24 slots), on the card. The captions are cycled (and masked
    anew)."""
    ds = datasets.MlmDataset(txt_db, img_db)
    idx = [i for i, t in enumerate(ds.ids)
           if lo < img_db.name2nbb[txt_db.txt2img[t]] <= Nb]
    order = [idx[k % len(idx)] for k in range(n * B)]
    spec = BucketSpec(TRAIN_TXT, Nb, B, TRAIN_SLOTS)
    return ([on_card(b) for b in datasets.batches(
        ds, spec, order, np.random.default_rng(seed))], len(idx))


def pretrain_optimizer(model):
    """The optimizer of config/uc2_pretrain.json."""
    with open("config/uc2_pretrain.json") as f:
        pc = json.load(f)
    return build_optimizer(
        model, get_lr_schedule(pc["decay"], pc["learning_rate"],
                               pc["warmup_steps"], pc["num_train_steps"]),
        weight_decay=pc["weight_decay"], betas=pc["betas"],
        grad_norm=pc["grad_norm"], optim=pc["optim"])


# kernel groups of the step breakdown, by marks in the kernel's name
KERNEL_GROUPS = (
    ("training attention kernels", ("attn_stream", "attn_bwd")),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def device_rows(prof):
    """(ms, count, name) of each device activity (kernels, copies) that a
    torch.profiler run recorded."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith(("Command Buffer", "Optimizer."))):
            rows.append((us / 1e3, e.count, e.key))
    return rows


def group_ms(rows, kernel_groups):
    """Device ms by kernel group (the first group whose mark is in the
    kernel's name; "other" for the rest)."""
    groups = {}
    for ms, _, key in rows:
        group = next((g for g, marks in kernel_groups if any(
            m in key for m in marks)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    return groups


# kernel groups of a scored batch
SCORE_GROUPS = (
    ("#3 FFN block", ("fused_ffn_kernel",)),
    ("#1 attention", ("attn_stream",)),
    ("#2 attention block", ("fused_attn_block",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def profile_scores(model, batch, L, card):
    """One scored batch under torch.profiler, after a warm-up call: its
    wall time, the device's busy and idle share, device ms by kernel group
    and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    model.scores(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.scores(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_rows(prof), reverse=True)
    if not rows:
        print(f"  L={L} profile: no device time recorded (not measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"  L={L} profiled batch: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall:.1%}; idle {1 - busy / wall:.1%}) "
          f"[{card}]")
    print("    device time by kernel group: " + ", ".join(
        f"{g} {ms:.3f} ms" for g, ms in sorted(
            group_ms(rows, SCORE_GROUPS).items(), key=lambda x: -x[1])))
    for ms, cnt, key in rows[:8]:
        print(f"    {ms:9.3f} ms {cnt:5d}x  {key[:90]}")


def profile_step(model, opt, batch, rng, card):
    """Device time of one step by kernel, from torch.profiler; None when
    the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, batch, rng)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    rows.sort(reverse=True)
    if not rows:
        print("  profiler: no device time recorded (not measured)")
        return None
    busy = sum(r[0] for r in rows)
    groups = group_ms(rows, KERNEL_GROUPS)
    attn = groups.get(KERNEL_GROUPS[0][0], 0.0)
    os.makedirs("build", exist_ok=True)
    with open("build/train_profile.txt", "w") as f:
        f.write(f"[{card}] one mlm step, B=128 L=162: wall {wall:.3f} ms\n")
        for ms, cnt, key in rows:
            f.write(f"{ms:10.3f} ms {cnt:6d}x  {key}\n")
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), training "
          f"attention kernels {attn:.3f} ms")
    print("  device time by kernel group: " + ", ".join(
        f"{g} {ms:.3f} ms" for g, ms in sorted(groups.items(),
                                               key=lambda x: -x[1])))
    for ms, cnt, key in rows[:12]:
        print(f"    {ms:9.3f} ms {cnt:5d}x  {key[:90]}")
    return busy


def step_vs_eager(cfg0, impl, batch, start, L):
    """One step at dropout 0 from the weights ``start``: the kernel path
    ``impl`` against the eager path ("xla"), held to the mlm step's limits
    (STEP_*). Returns the kernel path's launches."""
    layers = cfg0.num_hidden_layers
    lr = 4e-5
    out = {}
    for path in (impl, "xla"):
        m_ = UC2ForPretraining(cfg0.replace(use_pallas_attention=path),
                               device="cuda", seed=0)
        m_.load_state_dict(start)
        opt = build_optimizer(m_, constant(lr), weight_decay=0.01,
                              betas=(0.9, 0.98), grad_norm=5.0)
        reset_launches()
        met = train_step(m_, opt, batch, DropoutRng(0, "cuda"))
        # .grad after the step holds the clipped gradients: the clip (5.0)
        # is inactive at this step's grad norm (~4.35), checked below
        qkv = [m_.roberta.layer[i].attention.qkv.weight.grad.split(H)
               for i in range(layers)]
        out[path] = (met["loss"].item(), met["grad_norm"].item(),
                     torch.cat([(p.detach() - start[n]).flatten()
                                for n, p in m_.named_parameters()]), qkv,
                     launch_counts())
        del m_, opt
        torch.cuda.empty_cache()
    (lk, nk, dk, gk, ck), (le, ne, de, ge, _) = out[impl], out["xla"]
    diff = (dk - de).abs()
    flips = (diff > lr / 10).float().mean().item()
    qkv_rel = [max(((a[j] - b[j]).norm() / b[j].norm()).item()
                   for a, b in zip(gk, ge)) for j in range(3)]
    ok = (abs(lk - le) <= STEP_LOSS_TOL and abs(nk - ne) <= STEP_NORM_RTOL * ne
          and max(nk, ne) < 5.0 and max(qkv_rel) <= STEP_QKV_RTOL
          and diff.max().item() <= 2.05 * lr and flips <= STEP_FLIP_SHARE)
    print(f"  one step at dropout 0, L={L}, kernel path ({impl}) vs "
          f"eager (xla): loss {lk:.6f} vs {le:.6f}, grad norm {nk:.6f} vs "
          f"{ne:.6f}, worst layer's ||dW - dW_eager|| / ||dW_eager|| of the "
          f"Q / K / V projections {qkv_rel[0]:.3e} / {qkv_rel[1]:.3e} / "
          f"{qkv_rel[2]:.3e}, max|update difference| "
          f"{diff.max().item():.3e} (lr {lr:g}), share of updates differing "
          f"by > lr/10: {flips:.2e} (tolerance: loss {STEP_LOSS_TOL:g}, grad "
          f"norm {STEP_NORM_RTOL:g} relative, Q/K/V {STEP_QKV_RTOL:.3e}, "
          f"updates 2.05 lr, share {STEP_FLIP_SHARE:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the kernel training step ({impl}, L={L}) disagrees with the "
             f"eager step")
    return ck


def phase_train(card, train_rows):
    """The mlm step at full width on the three training buckets; returns
    the training kernels' launches over the timed runs. ``train_rows``:
    the kernel phase's rows of #5 and #6 (their times per call)."""
    print("== train: uc2-base mlm steps on the card (dropout 0.1, "
          "config/uc2_pretrain.json optimizer)")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention=True)
    t0 = time.perf_counter()
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    txt_db, img_db = synth_gallery(seed=1, n_imgs=N_IMGS, txt_per_img=2,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    print(f"  model ({sum(p.numel() for p in model.parameters())} params) "
          f"and corpus ({len(txt_db.ids)} captions of {N_IMGS} images) "
          f"ready in {time.perf_counter() - t0:.1f} s")
    layers = cfg.num_hidden_layers
    total = dict.fromkeys((k.__name__ for k in TRAIN_KERNELS), 0)
    lo = 0
    for B_, Nb in TRAIN_BUCKETS:
        L = TRAIN_TXT + Nb
        batches, n_caps = mlm_batches(txt_db, img_db, lo, Nb, B_,
                                      1 + TIMED_STEPS, seed=Nb)
        lo = Nb
        model.load_state_dict(start)
        opt = pretrain_optimizer(model)
        rng = DropoutRng(TRAIN_SEED, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        times, mets = [], []
        for i, batch in enumerate(batches):
            t1 = time.perf_counter()
            mets.append(train_step(model, opt, batch, rng))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launch_counts()
        steps = len(batches)
        want = no_launches()
        want.update({k.__name__: layers * steps for k in TRAIN_KERNELS})
        for k in TRAIN_KERNELS:
            total[k.__name__] += counts[k.__name__]
        losses = [(m["loss"].item(), m["grad_norm"].item(),
                   m["n_units"].item()) for m in mets]
        ms = sum(times[1:]) / TIMED_STEPS
        print(f"  L={L} B={B_} ({n_caps} captions in the bucket): "
              f"{ms:.3f} ms/step = {B_ / ms * 1e3:.1f} examples/s over "
              f"{TIMED_STEPS} steps (warm-up {times[0]:.1f} ms; steps "
              f"{', '.join(f'{t:.2f}' for t in times[1:])}), peak memory "
              f"{peak:.2f} GiB [{card}]")
        print(f"    loss / grad norm / slots per step: "
              + "; ".join(f"{a:.4f} / {b:.4f} / {int(c)}"
                          for a, b, c in losses))
        print(f"    launches {counts} over {steps} steps = "
              + " + ".join(f"{counts[k.__name__] / steps:g}"
                           for k in TRAIN_KERNELS)
              + f" per step, expected {want}")
        if counts != want:
            fail(f"training launches at L={L} are not 12 each of #5 and #6's "
                 f"two passes a step")
        if not all(np.isfinite(x) for r in losses for x in r[:2]):
            fail(f"a loss or grad norm at L={L} is not finite")

    # bitwise repeat, time breakdown and kernel vs eager at the last bucket
    batch = batches[0]
    res = []
    for _ in range(2):
        model.load_state_dict(start)
        m = train_step(model, pretrain_optimizer(model), batch,
                       DropoutRng(7, "cuda"))
        res.append((m["loss"], m["grad_norm"]))
    same = all(torch.equal(a, b) for a, b in zip(*res))
    print(f"  repeat of one step (L={L}, same weights and seeds): loss "
          f"{res[0][0].item():.6f} / {res[1][0].item():.6f}, grad norm "
          f"{res[0][1].item():.6f} / {res[1][1].item():.6f}; bitwise equal: "
          f"{same}")
    if not same:
        fail("one step with the same seeds is not bitwise repeatable")

    model.load_state_dict(start)
    opt = pretrain_optimizer(model)
    train_step(model, opt, batch, DropoutRng(8, "cuda"))     # warm
    busy = profile_step(model, opt, batch, DropoutRng(9, "cuda"), card)
    emb = model.roberta.embeddings.word_embeddings.weight
    h = torch.randn(B_, TRAIN_SLOTS, H, device="cuda").bfloat16()
    h.requires_grad_(True)

    def lm_head():
        logits = model.cls(h, emb)
        lm_heads.cross_entropy_with_logits(
            logits, batch["txt_labels"], batch["masked_weight"]).sum(
            ).backward()
    lm_ms = time_ms(lm_head, iters=5, warmup=1)
    # the decoder product alone: fp32 output of the bf16 product (the
    # port's einsum_f32 forward) against upcasting both operands to fp32
    x = model.cls.transform(h.reshape(-1, H)).detach()
    table = emb.detach().to(x.dtype)
    with torch.no_grad():
        mm_ms = time_ms(lambda: lm_heads.einsum_f32("...h,vh->...v", x,
                                                    table), iters=5)
        up_ms = time_ms(lambda: x.float() @ table.float().t(), iters=3)
    print(f"  LM decoder product alone ({x.shape[0]} x {cfg.vocab_size} x "
          f"{H}): bf16 operands, fp32 output {mm_ms:.3f} ms; both upcast to "
          f"fp32 (TF32 off) {up_ms:.3f} ms [{card}]")
    del x, table
    attn_ms = layers * sum(train_rows[k.__name__]["ms"]
                           for k in TRAIN_KERNELS)
    print(f"  LM head + CE, forward and backward (B*M = "
          f"{B_ * TRAIN_SLOTS} rows x {cfg.vocab_size} tokens): {lm_ms:.3f} "
          f"ms; training attention kernels: {layers} x (#5 + #6's two "
          f"passes) = "
          f"{attn_ms:.3f} "
          f"ms per step at L={L} [{card}]")
    del opt, h
    model.zero_grad(set_to_none=True)

    # kernel path vs eager path, one step at dropout 0 from one start
    cfg0 = cfg.replace(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    step_vs_eager(cfg0, "pallas-train", batch, start, L)
    return total, busy


FFN_ROWS = {
    "fused_ffn_block_train_fwd": dict(
        name="fused_ffn_block_train_fwd", route="cuda",
        source="uc2_torch/csrc/fused_ffn_block.cu",
        replaces="uc2_tpu/ops/ffn_train.py:68"),
    "fused_ffn_block_train_bwd": dict(
        name="fused_ffn_block_train_bwd", route="cuda",
        source="uc2_torch/csrc/ffn_train_bwd.cu",
        replaces="uc2_tpu/ops/ffn_train.py:90"),
}
FFN_SEED = 4321
# #10's weight and vector gradients sum ~20k rows in another order than
# the plain version: held in relative norm to 1e-3; against autograd of the
# plain forward, which rounds dh to bf16 where the reference's formula
# rounds dy2 and da, to 2^-7
FFN_GRAD_RTOL, FFN_AUTO_RTOL = 1e-3, 2.0 ** -7
FFN_GRADS = ("dW1", "db1", "dW2", "db2", "dgamma", "dbeta")
# #10's tile edges (128-row product tiles, 64-row row-pass tiles, 128
# columns of F) at uc2-base's F and at another width the wrapper takes
FFN_BWD_EDGES = tuple((rows, Fi) for rows in (1, 63, 64, 65, 129)
                      for Fi in (FF, 384))


def ffn_weights(gen, F=FF):
    def w(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.05).bfloat16()
    return (w(F, H), vec(gen, F, 0.02), w(H, F), vec(gen, H, 0.02),
            vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1))


def ffn_plain_autograd(x, w1, b1, w2, b2, gamma, beta, rate, dy):
    """The seven gradients by autograd through the plain forward."""
    ins = [t.detach().requires_grad_(True)
           for t in (x, w1, b1, w2, b2, gamma, beta)]
    out = fused_ffn_block_train_plain(*ins, FFN_SEED, rate)
    return torch.autograd.grad(out, ins, dy)


def eager_ffn_bwd_ms(x, w1, b1, w2, b2, gamma, beta, rate, dy):
    """#10's yardstick: the autograd backward of the eager chain (F.linear
    -> erf GELU -> F.linear -> dropout -> + x -> LayerNorm, bf16, its own
    dropout RNG) against dy, chained and replayed from a CUDA graph (None,
    with the reason printed, where it cannot be captured)."""
    ins = [t.detach().bfloat16().requires_grad_(True)
           for t in (x, w1, b1, w2, b2, gamma, beta)]
    xi, w1i, b1i, w2i, b2i, gi, bi = ins
    side = torch.cuda.Stream()      # the forward on a side stream, so that
    side.wait_stream(torch.cuda.current_stream())    # its backward can be
    with torch.cuda.stream(side):                    # captured
        y = F.dropout(F.linear(F.gelu(F.linear(xi, w1i, b1i)), w2i, b2i),
                      rate, training=True)
        out = F.layer_norm(y + xi, (H,), gi, bi, 1e-12)
    torch.cuda.current_stream().wait_stream(side)

    def bwd():
        return torch.autograd.grad(out, ins, dy, retain_graph=True)
    chained = time_ms(bwd, iters=10)
    try:
        graph = graph_ms(bwd, iters=5, stream=side)
    except RuntimeError as e:
        print(f"    eager chain's autograd backward could not be captured in "
              f"a CUDA graph: {str(e).splitlines()[0]}")
        torch.cuda.synchronize()
        graph = None
    return chained, graph


def profile_kernels(what, fn, card):
    """One call of ``fn`` under torch.profiler, after a warm-up call: the
    device ms of each kernel it launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(device_rows(prof), reverse=True)
    if not rows:
        print(f"    {what} under torch.profiler: no device time recorded (not "
              f"measured)")
        return
    print(f"    {what}, one call under torch.profiler: {sum(r[0] for r in rows):.4f}"
          f" ms of device time in {sum(r[1] for r in rows)} kernels [{card}]")
    for ms, cnt, key in rows:
        print(f"      {ms:8.4f} ms {cnt:3d}x  {key[:110]}")


def time_ffn_bwd(gen, card):
    """#10 at the mix bucket's rows (B = 128, L = 162), rate 0.1: chained
    and replayed from a CUDA graph, each of its kernels' device time from
    one profiled call, beside the eager chain's autograd backward and the
    bound; returns (inputs, the bound's bytes and operations)."""
    rows, rate = 128 * 162, 0.1
    w1, b1, w2, b2, gamma, beta = ffn_weights(gen)
    x = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    bargs = (x, w1, b1, w2, b2, gamma, FFN_SEED, rate, 1e-12, dy)
    kern = lambda: fused_ffn_block_train_bwd(*bargs)
    nbytes = (3 * rows * H * 2 + 2 * H * FF * 2 + 2 * H * FF * 4
              + (2 * FF + 6 * H) * 4)
    lo, by = bound(nbytes, 12 * rows * H * FF)
    ms, g_ms = time_ms(kern, iters=10), graph_ms(kern, iters=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kern()
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    e_ms, e_g = eager_ffn_bwd_ms(x, w1, b1, w2, b2, gamma, beta, rate, dy)
    e_gs = "n/a" if e_g is None else f"{e_g:.4f}"
    print(f"    #10 rows={rows} rate={rate}: kernel {ms:.4f} ms (graph "
          f"{g_ms:.4f}), eager chain's autograd backward {e_ms:.4f} ms (graph "
          f"{e_gs}), bound {lo:.4f} ms ({by}); kernel / eager chain "
          f"{ms / e_ms:.2f}, kernel / bound {ms / lo:.1f}; peak memory of a "
          f"call above its inputs {scratch:.0f} MiB [{card}]")
    profile_kernels(f"#10 rows={rows} rate={rate}", kern, card)
    return bargs, (nbytes, 12 * rows * H * FF)


def time_ffn_fwd(gen, card):
    """#9 at the mix bucket's rows (B = 128, L = 162), rates 0.1 and 0,
    chained and replayed from a CUDA graph, beside #3 on the same inputs
    (the function without the dropout step; at rate 0 #9 computes it too)
    and at the scoring bucket's rows (B = 64, L = 162), also both ways."""
    rows = 128 * 162
    w1, b1, w2, b2, gamma, beta = ffn_weights(gen)
    x = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    lo, by = bound(2 * rows * H * 2 + 2 * H * FF * 2 + (FF + 3 * H) * 4,
                   4 * rows * H * FF)
    for rate in (0.1, 0.0):
        kern = lambda: fused_ffn_block_train_fwd(x, w1, b1, w2, b2, gamma,
                                                 beta, FFN_SEED, rate)
        ms, g_ms = time_ms(kern, iters=10), graph_ms(kern, iters=10)
        print(f"    #9 rows={rows} rate={rate}: kernel {ms:.4f} ms (graph "
              f"{g_ms:.4f}), bound {lo:.4f} ms ({by}); kernel / bound "
              f"{ms / lo:.1f} [{card}]")
    for n in (rows, 64 * 162):
        xs = x[:n]
        kern = lambda: fused_ffn_block(xs, w1, b1, w2, b2, gamma, beta)
        print(f"    #3 rows={n}: kernel {time_ms(kern, iters=10):.4f} ms "
              f"(graph {graph_ms(kern, iters=10):.4f}) [{card}]")


def phase_ffn_times(gen, card):
    """``--times``: #9 and #3 as ``time_ffn_fwd`` times them, #10 as
    phase 5 times it."""
    time_ffn_fwd(gen, card)
    time_ffn_bwd(gen, card)


def phase_ffn_kernels(gen, card):
    """#9 and #10 against their plain versions at the training buckets'
    rows, #10 also at the edges of its tiles, each #10 call repeated bit for
    bit; #10 timed from a CUDA graph, by kernel and beside the eager chain;
    the rows' times are those of B = 128, L = 162, rate 0.1."""
    print("== training FFN kernels vs plain (#9 forward, #10 backward; plain: "
          "fp32 compute on the same bf16 inputs)")
    rows_out = {k: dict(v) for k, v in FFN_ROWS.items()}
    fwd_row, bwd_row = rows_out.values()
    w1, b1, w2, b2, gamma, beta = ffn_weights(gen)
    for b, L in ((208, 98), (160, 128), (128, 162)):
        rows = b * L
        x = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            args = (x, w1, b1, w2, b2, gamma, beta, FFN_SEED, rate)
            bargs = (x, w1, b1, w2, b2, gamma, FFN_SEED, rate, 1e-12, dy)
            tag = f"rows={rows} (B={b} L={L}) rate={rate}"
            ef = compare(f"#9 {tag}", fused_ffn_block_train_fwd(*args),
                         fused_ffn_block_train_plain(*args))
            got = fused_ffn_block_train_bwd(*bargs)
            want = fused_ffn_block_train_bwd_plain(*bargs)
            eb = compare(f"#10 dx {tag}", got[0], want[0])
            for nm, a, w in zip(FFN_GRADS, got[1:], want[1:]):
                compare_norm(f"#10 {nm} {tag}", a, w, FFN_GRAD_RTOL)
            auto = ffn_plain_autograd(x, w1, b1, w2, b2, gamma, beta, rate,
                                      dy)
            compare(f"#10 dx vs autograd of plain fwd {tag}", got[0], auto[0])
            for nm, a, w in zip(FFN_GRADS, got[1:], auto[1:]):
                compare_norm(f"#10 {nm} vs autograd of plain fwd {tag}", a, w,
                             FFN_AUTO_RTOL)
            fwd_row["max_abs_err"] = max(fwd_row.get("max_abs_err", 0.0), ef)
            bwd_row["max_abs_err"] = max(bwd_row.get("max_abs_err", 0.0), eb)
            if (b, L, rate) != (128, 162, 0.1):
                continue
            weights = 2 * H * FF * 2
            for row, kern, plain, nbytes, flops in (
                    (fwd_row, lambda: fused_ffn_block_train_fwd(*args),
                     lambda: fused_ffn_block_train_plain(*args),
                     2 * rows * H * 2 + weights + (FF + 3 * H) * 4,
                     4 * rows * H * FF),
                    (bwd_row, lambda: fused_ffn_block_train_bwd(*bargs),
                     lambda: fused_ffn_block_train_bwd_plain(*bargs),
                     3 * rows * H * 2 + weights + 2 * H * FF * 4
                     + (2 * FF + 6 * H) * 4,
                     12 * rows * H * FF)):
                row.update(ms=time_ms(kern, iters=10),
                           plain_ms=time_ms(plain, iters=3), library_ms=None)
                row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
                print(f"    {row['name']} {tag}: kernel {row['ms']:.4f} ms, "
                      f"plain {row['plain_ms']:.4f} ms, library none (no "
                      f"single PyTorch call computes it), bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            print(f"    #10 without the recompute (8 rows H F = "
                  f"{8 * rows * H * FF / 1e9:.1f} GFLOP) would be bound at "
                  f"{8 * rows * H * FF / PEAK_BF16_FLOPS * 1e3:.4f} ms")
            repeat_bitwise(f"#10 {tag}", lambda: fused_ffn_block_train_bwd(
                *bargs), got)
    # #9 and #3 from CUDA graphs; #10 from a CUDA graph, its kernels from
    # one profiled call, beside the eager chain's autograd backward
    time_ffn_fwd(gen, card)
    time_ffn_bwd(gen, card)
    # #9 at the edges of #3's tiles, each call repeated bit for bit; at
    # rate 0 it is #3's launch, bit for bit
    for n_rows, Fi in FFN_EDGES:
        x = torch.randn(n_rows, H, generator=gen, device="cuda").bfloat16()
        args = (x, w1[:Fi].contiguous(), b1[:Fi].contiguous(),
                w2[:, :Fi].contiguous(), b2, gamma, beta)
        for rate in (0.1, 0.0):
            tag = f"rows={n_rows} F={Fi} rate={rate}"
            got = fused_ffn_block_train_fwd(*args, FFN_SEED, rate)
            ef = compare(f"#9 {tag}", got,
                         fused_ffn_block_train_plain(*args, FFN_SEED, rate))
            fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], ef)
            repeat_bitwise(f"#9 {tag}", lambda: fused_ffn_block_train_fwd(
                *args, FFN_SEED, rate), got)
        if not torch.equal(got, fused_ffn_block(*args)):
            fail(f"#9 at rate 0 is not #3 bit for bit at rows={n_rows} "
                 f"F={Fi}")
    print(f"  #9 at rate 0 == #3 bit for bit at {len(FFN_EDGES)} row counts")
    # #10 at the edges of its tiles, each call repeated bit for bit
    for n_rows, Fi in FFN_BWD_EDGES:
        w1e, w2e = w1[:Fi].contiguous(), w2[:, :Fi].contiguous()
        x = torch.randn(n_rows, H, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(n_rows, H, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            bargs = (x, w1e, b1[:Fi].contiguous(), w2e, b2, gamma, FFN_SEED,
                     rate, 1e-12, dy)
            tag = f"rows={n_rows} F={Fi} rate={rate}"
            got = fused_ffn_block_train_bwd(*bargs)
            want = fused_ffn_block_train_bwd_plain(*bargs)
            eb = compare(f"#10 dx {tag}", got[0], want[0])
            for nm, a, w in zip(FFN_GRADS, got[1:], want[1:]):
                compare_norm(f"#10 {nm} {tag}", a, w, FFN_GRAD_RTOL)
            bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"], eb)
            repeat_bitwise(f"#10 {tag}", lambda: fused_ffn_block_train_bwd(
                *bargs), got)
    # the mask, exactly: x = 0, W2 = 0, b2 = 1, gamma = 1, beta = 0 make
    # each pre-LN row 2 where kept and 0 where dropped (rate 0.5)
    rows, rate = 4096, 0.5
    out = fused_ffn_block_train_fwd(
        torch.zeros(rows, H, device="cuda").bfloat16(), w1, b1,
        torch.zeros_like(w2), torch.ones(H, device="cuda"),
        torch.ones(H, device="cuda"), torch.zeros(H, device="cuda"), FFN_SEED,
        rate)
    keep = ffn_keep_mask(FFN_SEED, rate, rows, H, "cuda")
    mixed = keep.any(1) & ~keep.all(1)
    same = torch.equal((out > 0)[mixed], keep[mixed])
    print(f"  mask check ({rows} rows x {H}, rate 0.5): sign of #9's output "
          f"== plain Philox mask bit for bit: {same} ({rows - int(mixed.sum())}"
          f" rows that keep all or nothing skipped; kept share "
          f"{keep.float().mean().item():.4f})")
    if not same:
        fail("the training FFN kernel's dropout mask is not the Philox mask")
    return rows_out


# the pretraining mix: one bucket (62 text tokens, 100 regions, B = 128),
# each task's slots (config/uc2_pretrain.json tasks; vmlm's from
# VmlmDataset.slot_budget)
MIX_TASKS = ("itm", "mlm", "vmlm", "tlm")
MIX_B, MIX_NB, MIX_STEPS = 128, 100, 3
# dropout 0, one step of the kernel path ("pallas-train" + UC2_FFN_TRAIN=1)
# against the eager path ("xla") for itm and vmlm: |loss difference|, grad
# norm (relative), and the worst layer's W1 and W2 gradients (fed by #10)
# in relative norm. Limits about 5x the first H100 readings (itm 1.5e-5,
# 9.0e-3, 2.5e-2; vmlm 1.5e-4, 1.3e-4, 1.3e-2); an fp32 eager step is
# printed beside them as the anchor of both bf16 paths
MIX_LIMITS = {"itm": (1e-4, 4.5e-2, 2.0 ** -3),
              "vmlm": (7.5e-4, 6.4e-4, 2.0 ** -4)}


def mix_batches(cfg, n, seed):
    """``n`` batches of each task of the mix on the card, from the port's
    datasets and collate over a synthetic paired corpus (the cc_de
    dataset of config/uc2_pretrain.json runs all four tasks)."""
    with open("config/uc2_pretrain.json") as f:
        pc = json.load(f)
    txt_db, img_db = synth_pretrain_corpus(seed, n_imgs=N_IMGS,
                                           txt_per_img=2,
                                           vocab=cfg.vocab_size,
                                           img_dim=cfg.img_dim)
    vocab = LabelVocab(tokenize=hash_tokenize)
    rng = np.random.default_rng(seed)
    sets = {
        "itm": datasets.ItmDataset(txt_db, img_db,
                                   neg_sample_p=pc["itm_neg_prob"]),
        "mlm": datasets.MlmDataset(txt_db, img_db),
        "vmlm": datasets.VmlmDataset(txt_db, img_db, label_vocab=vocab,
                                     lang="de"),
        "tlm": datasets.TlmDataset(txt_db, img_db,
                                   comasking_mode=pc["comasking_mode"]),
    }
    sets["itm"].new_epoch(rng)
    out = {}
    for task, ds in sets.items():
        M = (0 if task == "itm" else type(ds).slot_budget(TRAIN_TXT, MIX_NB)
             if task == "vmlm" else TRAIN_SLOTS)
        spec = BucketSpec(TRAIN_TXT, MIX_NB, MIX_B, M)
        idx = rng.permutation(len(ds))[:n * MIX_B]
        out[task] = [on_card(b)
                     for b in datasets.batches(ds, spec, idx, rng)]
    return out, len(txt_db.ids)


def ffn_grads(model):
    """Each layer's W1 and W2 gradients."""
    return [(lay.intermediate_dense.weight.grad,
             lay.output_dense.weight.grad) for lay in model.roberta.layer]


@contextlib.contextmanager
def env_set(name, value):
    """The environment variable ``name`` set to ``value`` (None: unset)
    inside the block, restored after."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def phase_mix(card, train_busy, ffn_rows):
    """The four tasks of the mix under "pallas-train" with UC2_FFN_TRAIN=1
    (set here and restored after); returns #9/#10's launches over the
    tasks' timed runs."""
    print("== mix: uc2-base steps of itm / mlm / vmlm (de) / tlm (mix) on the "
          "card under pallas-train with UC2_FFN_TRAIN=1 (dropout 0.1, "
          "config/uc2_pretrain.json optimizer)")
    with env_set("UC2_FFN_TRAIN", "1"):
        return _phase_mix(card, train_busy, ffn_rows)


def _phase_mix(card, train_busy, ffn_rows):
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention="pallas-train")
    t0 = time.perf_counter()
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    batches, n_txt = mix_batches(cfg, 1 + MIX_STEPS, seed=2)
    L = TRAIN_TXT + MIX_NB
    print(f"  model and corpus ({n_txt} paired captions of {N_IMGS} images), "
          f"batches of (Lt={TRAIN_TXT}, Nb={MIX_NB}, B={MIX_B}) ready in "
          f"{time.perf_counter() - t0:.1f} s; label vocabulary: hash ids")
    layers = cfg.num_hidden_layers
    per_step = no_launches()
    per_step.update({k.__name__: layers for k in TRAIN_KERNELS + FFN_KERNELS})
    total = dict.fromkeys((k.__name__ for k in FFN_KERNELS), 0)
    for task in MIX_TASKS:
        model.load_state_dict(start)
        opt = pretrain_optimizer(model)
        rng = DropoutRng(TRAIN_SEED, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, mets = [], []
        for i, batch in enumerate(batches[task]):
            if i == 1:
                torch.cuda.synchronize()
                reset_launches()
            t1 = time.perf_counter()
            mets.append(train_step(model, opt, batch, rng, task=task))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launch_counts()
        for k in FFN_KERNELS:
            total[k.__name__] += counts[k.__name__]
        want = {k: v * MIX_STEPS for k, v in per_step.items()}
        stats = [(m["loss"].item(), m["grad_norm"].item(),
                  m["n_units"].item()) for m in mets]
        ms = sum(times[1:]) / MIX_STEPS
        M = batches[task][0].get("masked_pos")
        print(f"  {task} L={L} B={MIX_B} M={0 if M is None else M.shape[1]}:"
              f" {ms:.3f} ms/step = {MIX_B / ms * 1e3:.1f} examples/s over "
              f"{MIX_STEPS} steps (warm-up {times[0]:.1f} ms; steps "
              f"{', '.join(f'{t:.2f}' for t in times[1:])}), peak memory "
              f"{peak:.2f} GiB (LM head unchunked) [{card}]")
        print(f"    loss / grad norm / units per step: "
              + "; ".join(f"{a:.4f} / {b:.4f} / {int(c)}" for a, b, c in stats))
        print(f"    launches over the timed steps {counts}, expected {want}")
        if counts != want:
            fail(f"{task}: launches are not 12 each of #5, #6's two passes, "
                 f"#9 and #10 a step")
        if not all(np.isfinite(x) for r in stats for x in r[:2]):
            fail(f"{task}: a loss or grad norm is not finite")

    repeat_step("vmlm", model, start, batches["vmlm"][0], {})

    # the mlm step with the eager FFN (UC2_FFN_TRAIN unset) and with #9/#10
    ab = {}
    for env in ("unset", "1", "1", "unset"):
        if env == "1":
            os.environ["UC2_FFN_TRAIN"] = "1"
        else:
            os.environ.pop("UC2_FFN_TRAIN")
        model.load_state_dict(start)
        opt = pretrain_optimizer(model)
        rng = DropoutRng(TRAIN_SEED, "cuda")
        train_step(model, opt, batches["mlm"][0], rng)      # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for batch in batches["mlm"][1:]:
            train_step(model, opt, batch, rng)
        torch.cuda.synchronize()
        ab.setdefault(env, []).append((time.perf_counter() - t1) * 1e3
                                      / MIX_STEPS)
    os.environ["UC2_FFN_TRAIN"] = "1"
    kern_ms = layers * (ffn_rows["fused_ffn_block_train_fwd"]["ms"]
                        + ffn_rows["fused_ffn_block_train_bwd"]["ms"])
    eager_ms = eager_ffn_ms(model)
    eager = ("not measured" if eager_ms is None else
             f"{layers} x {eager_ms:.3f} = {layers * eager_ms:.3f} ms")
    if eager_ms is not None and train_busy is not None:
        eager += (f" ({layers * eager_ms / train_busy:.1%} of the profiled "
                  f"mlm step's {train_busy:.3f} ms device time)")
    print(f"  A/B mlm step at L={L}, B={MIX_B} (runs in turns unset, set, "
          f"set, unset): eager FFN {', '.join(f'{t:.3f}' for t in ab['unset'])}"
          f" ms/step; FFN kernels #9/#10 "
          f"{', '.join(f'{t:.3f}' for t in ab['1'])} ms/step [{card}]")
    print(f"  FFN device time per step: {layers} x (#9 + #10) = {kern_ms:.3f} "
          f"ms (CUDA events, kernel phase); eager FFN block forward + "
          f"backward (profiler, kernels only) {eager} [{card}]")

    # dropout 0: one itm and one vmlm step, kernel path vs eager path, an
    # fp32 eager step beside them as the anchor of both bf16 paths
    cfg0 = cfg.replace(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    for task, limits in MIX_LIMITS.items():
        models = {path: UC2ForPretraining(
            cfg0.replace(use_pallas_attention=impl, dtype=dt),
            device="cuda", seed=0) for path, (impl, dt) in (
                ("kernel", ("pallas-train", "bfloat16")),
                ("eager", ("xla", "bfloat16")),
                ("eager fp32", ("xla", "float32")))}
        step_at_dropout_0(task, task, models, start, batches[task][0], {},
                          limits, layers)
        del models
        torch.cuda.empty_cache()
    return total


def eager_ffn_ms(model):
    """Device time (torch.profiler, kernels only, so host launch gaps do
    not count) of the eager FFN chain of one layer, forward and backward,
    at the mix bucket's shape; None when the profiler sees none."""
    from torch.profiler import ProfilerActivity, profile
    lay = model.roberta.layer[0]
    x = torch.randn(MIX_B, TRAIN_TXT + MIX_NB, H, device="cuda").bfloat16()
    x.requires_grad_(True)
    g = torch.randn_like(x)
    rng = DropoutRng(3, "cuda")
    rate = model.config.hidden_dropout_prob
    params = [x] + [p for mod in (lay.intermediate_dense, lay.output_dense,
                                  lay.output_LayerNorm)
                    for p in (mod.weight, mod.bias)]

    def step():
        h = lay.output_dense(gelu(lay.intermediate_dense(x)))
        out = lay.output_LayerNorm(dropout(h, rate, rng) + x)
        torch.autograd.grad(out, params, g)
    step()
    torch.cuda.synchronize()
    iters = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(r[0] for r in rows) / iters if rows else None


# ------------------------------------------------------------ long captions
LONG_ROWS = {
    "flash_attention_long": dict(
        name="flash_attention_long", route="cuda",
        source="uc2_torch/csrc/attention_stream.cuh",
        replaces="uc2_tpu/ops/flash_attention.py:33"),
}
# where the main path launches #5 and #6 (training buckets, then long
# captions), #4 (the long-caption buckets at dropout 0) and #1 (the L = 98
# scoring bucket, the lab, the long-caption buckets below L = 419 at
# dropout 0)
TRAIN5_SHAPES = ((208, 98), (160, 128), (128, 162), (56, 174), (24, 339),
                 (16, 512))
LONG4_SHAPES = ((16, 512), (4, 419), (4, 450))
V3_SHAPES = ((64, 98), (64, 162), (56, 174), (24, 339))


def time_long(rows, gen, b, L, report=False):
    """#4 at (b, L) against its plain version, timed beside SDPA and its
    bound, both also replayed from CUDA graphs and on the host's clock."""
    q, k, v, bias = heads(gen, b, L)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias16 = bias.bfloat16()
    run_case(rows, "flash_attention_long", b, L, flash_attention_long,
             flash_attention_long_plain, (q, k, v, bias),
             4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D,
             library=lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=bias16), report=report, graph=True)


def time_v3(gen, b, L):
    """#1 at (b, L) against its plain version, timed beside SDPA and its
    bound, both also replayed from CUDA graphs and on the host's clock;
    at the scoring shape (64, 98) also the host's clock of the C entry
    alone, bare and through ``build.launch``. Returns the error (phase 2
    keeps #1's row)."""
    q, k, v, bias = heads(gen, b, L)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias16 = bias.bfloat16()
    rows = {"flash_attention": dict(name="flash_attention")}
    run_case(rows, "flash_attention", b, L, flash_attention_v3,
             flash_attention_plain, (q, k, v, bias),
             4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D,
             library=lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=bias16), graph=True)
    if (b, L) == V3_SHAPES[0]:
        out = torch.empty(b, L, N, D, dtype=q.dtype, device="cuda")
        c_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), b, L, N, heads_row_stride(q, k, v),
                  1.0 / D ** 0.5)
        entry = build.load().uc2_attn_fwd
        stream = torch.cuda.current_stream().cuda_stream
        bare = host_ms(lambda: entry(*c_args, stream))
        bound_call = host_ms(lambda: build.launch("uc2_attn_fwd", *c_args,
                                                  device=q.device))
        print(f"    #1's host clock per call at B={b} L={L}: C entry alone "
              f"{bare:.4f} ms (ctypes, four tensor-map encodes, the "
              f"launch), through build.launch {bound_call:.4f} ms; the rest "
              f"of the wrapper's time above is its Python checks and "
              f"torch.autograd.Function")
    return rows["flash_attention"]["max_abs_err"]


def phase_stream_times(gen):
    """``--times``: #5 and #6 at rate 0.1 at each of their main-path
    shapes, #4 at its three and #1 at its four, timed as phases 2 and 6
    time them and nothing else; copied into another tree of the port (the
    parent commit's, say), this script times that tree's kernels in the
    same call."""
    for b, L in TRAIN5_SHAPES:
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        time_fwd(f"B={b} L={L} rate=0.1", q, k, v, bias, 0.1)
        time_bwd(f"B={b} L={L} rate=0.1", q, k, v, bias, g, 0.1)
    rows = {k: dict(v) for k, v in LONG_ROWS.items()}
    for b, L in LONG4_SHAPES:
        time_long(rows, gen, b, L)
    for b, L in V3_SHAPES:
        time_v3(gen, b, L)


AB_STEPS = 10         # timed mlm steps of ``--times``, after two warm-ups


def time_mlm_step(card):
    """``--times``: phase 4's mlm step at its L = 162 bucket (B = 128,
    dropout 0.1, the same weights, corpus and optimizer), two warm-up
    steps and AB_STEPS timed ones; prints each step's time, the mean and
    the median."""
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention=True)
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    txt_db, img_db = synth_gallery(seed=1, n_imgs=N_IMGS, txt_per_img=2,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    (_, lo), (B_, Nb) = TRAIN_BUCKETS[1:]
    batches, _ = mlm_batches(txt_db, img_db, lo, Nb, B_, 2 + AB_STEPS,
                             seed=Nb)
    opt = pretrain_optimizer(model)
    rng = DropoutRng(TRAIN_SEED, "cuda")
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        train_step(model, opt, batch, rng)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    t = times[2:]
    print(f"  mlm step L={TRAIN_TXT + Nb} B={B_}: mean {np.mean(t):.3f} ms, "
          f"median {np.median(t):.3f} ms over {AB_STEPS} steps (steps "
          f"{', '.join(f'{x:.2f}' for x in t)}) [{card}]")


# joint lengths at the edges of the streamed core's 64-row query and key
# tiles, and the main path's
STREAM_TAILS = (1, 63, 64, 65, 127, 129, 162, 174, 257, 339, 419, 450, 511,
                512)


def stream_core_checks(gen):
    """#1, #4, #5 and #11 share one core (csrc/attention_stream.cuh): #4,
    #5 and #11 each against its plain version at STREAM_TAILS with B = 3,
    on views into one fused QKV projection, #5 at rates 0.1 and 0; every call
    repeated bit for bit; #5 at rate 0 and #1 bitwise equal to #4 on the
    same inputs. Returns #4's largest error."""
    print("  the streamed core at the tiles' edges (B = 3, fused-QKV views):")
    e4 = 0.0
    for L in STREAM_TAILS:
        q, k, v, bias = heads(gen, 3, L)
        out4 = flash_attention_long(q, k, v, bias)
        ok4, err4 = close(out4, flash_attention_long_plain(q, k, v, bias))
        same = torch.equal(out4, flash_attention_long(q, k, v, bias))
        e4 = max(e4, err4)
        line = [f"#4 {err4:.2e}"]
        oks = [ok4]
        for rate in (0.1, 0.0):
            args = (q, k, v, bias, TRAIN_SEED + L, rate)
            out5 = flash_attention_train_fwd(*args)
            ok5, err5 = close(out5, flash_attention_train_plain(*args))
            same = same and torch.equal(out5, flash_attention_train_fwd(*args))
            oks.append(ok5)
            line.append(f"#5 rate {rate} {err5:.2e}")
        out11 = attention_bf16_probs(q, k, v, bias)
        ok11, err11 = close(out11, attention_bf16_probs_plain(q, k, v, bias))
        same = same and torch.equal(out11, attention_bf16_probs(q, k, v, bias))
        oks.append(ok11)
        line.append(f"#11 {err11:.2e}")
        one = torch.equal(out5, out4)
        v3 = torch.equal(flash_attention_v3(q, k, v, bias), out4)
        print(f"    L={L}: max|kernel - plain| {', '.join(line)} "
              f"{'ok' if all(oks) else 'FAIL'}; repeats bitwise: {same}; "
              f"#5 at rate 0 == #4 bitwise: {one}; #1 == #4 bitwise: {v3}")
        if not all(oks):
            fail(f"the streamed core at L = {L} disagrees with its plain "
                 f"version")
        if not same:
            fail(f"the streamed core at L = {L} is not bitwise repeatable")
        if not one:
            fail(f"#5 at rate 0 and #4 differ at L = {L}")
        if not v3:
            fail(f"#1 and #4 differ at L = {L}")
    return e4


def bwd_tail_checks(gen, rows):
    """#6 at STREAM_TAILS (the edges of its passes' 64-row tiles), B = 3,
    on views into one fused QKV projection, rates 0.1 and 0: dq, dk, dv
    and dbias against the plain backward, each pass against its plain
    version (pass 1's keep bits bit for bit), and each call repeated bit
    for bit. Folds the errors into the rows."""
    print("  #6 at the tiles' edges (B = 3, fused-QKV views):")
    for L in STREAM_TAILS:
        q, k, v, bias = heads(gen, 3, L)
        g = torch.randn(3, L, N, D, generator=gen, device="cuda").bfloat16()
        errs, oks, same = [], [], True
        for rate in (0.1, 0.0):
            args = (q, k, v, bias, TRAIN_SEED + L, rate)
            got = flash_attention_train_bwd(*args, g)
            whole = [close(a, w) for a, w in zip(
                got, flash_attention_train_bwd_plain(*args, g))]
            again = flash_attention_train_bwd(*args, g)
            _, _, res, ok_bits, same_p = check_passes(
                f"L={L} rate={rate}", *args, g, rows, quiet=True)
            (ok1, e1), (ok2, e2) = res.values()
            same = (same and same_p
                    and all(torch.equal(a, w) for a, w in zip(got, again)))
            oks += [ok for ok, _ in whole] + [ok1, ok2, ok_bits]
            errs.append(f"rate {rate}: #6 "
                        f"{max(e for _, e in whole):.2e}, pass 1 {e1:.2e}, "
                        f"pass 2 {e2:.2e}, bits "
                        f"{'equal' if ok_bits else 'DIFFER'}")
            # #6's dq is pass 1's, its dk, dv and dbias pass 2's
            fold_err(rows, "flash_attention_train_bwd_dq", whole[0][1])
            fold_err(rows, "flash_attention_train_bwd_dkdv",
                     max(e for _, e in whole[1:]))
        print(f"    L={L}: max|kernel - plain| {'; '.join(errs)} "
              f"{'ok' if all(oks) else 'FAIL'}; repeats bitwise: {same}")
        if not all(oks):
            fail(f"#6 at L = {L} disagrees with its plain version")
        if not same:
            fail(f"#6 at L = {L} is not bitwise repeatable")


def phase_long_kernels(gen, train_rows):
    """The streamed core's edge cases (``stream_core_checks``) and #6's
    (``bwd_tail_checks``, errors folded into ``train_rows``); #4 against
    its plain version at (B, L) = (16, 512), (4, 419) and (4, 450), timed
    beside SDPA and its bound, replayed from a CUDA graph, and on the
    host's clock beside #1's wrapper; #1 timed the same way at V3_SHAPES;
    ``train_attention_case`` at (56, 174), (24, 339) and (16, 512), rates
    0.1 and 0, #5 and #6 timed beside SDPA at rate 0.1 (#6 also from a
    CUDA graph); the forward's mask at L = 512. #4's row times are those
    of (16, 512)."""
    print("== long-L attention kernels vs plain (#4 and #1 inference "
          "forward; #5 and #6 beyond the training buckets; plain: fp32 "
          "compute on the same bf16 inputs)")
    rows = {k: dict(v) for k, v in LONG_ROWS.items()}
    rows["flash_attention_long"]["max_abs_err"] = stream_core_checks(gen)
    bwd_tail_checks(gen, train_rows)
    for b, L in LONG4_SHAPES:
        time_long(rows, gen, b, L, (b, L) == (16, 512))
    e1 = max(time_v3(gen, b, L) for b, L in V3_SHAPES)
    print(f"  #1 at {V3_SHAPES}: largest |kernel - plain| {e1:.4e}")
    for b, L in ((56, 174), (24, 339), (16, 512)):
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            tag = f"B={b} L={L} rate={rate}"
            train_attention_case(tag, q, k, v, bias, g, rate, train_rows)
            if rate > 0.0:
                time_fwd(tag, q, k, v, bias, rate)
                time_bwd(tag, q, k, v, bias, g, rate)
    # the mask, exactly, at L = 512: q = k = 0, bias 0, v = the first 64
    # columns of I make output column c the dropped, rescaled P[:, c]
    L, rate = 512, 0.5
    z = torch.zeros(1, L, 1, D, device="cuda").bfloat16()
    eye = torch.eye(L, D, device="cuda").bfloat16().reshape(1, L, 1, D)
    out = flash_attention_train_fwd(z, z, eye, torch.zeros(1, 1, 1, L,
                                                           device="cuda"),
                                    TRAIN_SEED, rate)[0, :, 0, :]
    keep = keep_mask(TRAIN_SEED, rate, 1, 1, L, L, "cuda")[0, 0, :, :D]
    same = torch.equal(out != 0, keep) and bool((out[keep] == 2.0 / L).all())
    print(f"  mask check (L = 512, keys 0..63, rate 0.5): #5's zeros == plain "
          f"Philox mask bit for bit: {same}")
    if not same:
        fail("the training kernel's dropout mask at L = 512 is not the "
             "Philox mask")
    return rows


# pretrain.py's buckets for captions of up to 410 tokens, 100 regions and
# config/uc2_pretrain.json's 10240 tokens a batch: joint L = 174 / 339 / 512
# at B = 56 / 24 / 16 (default_buckets)
LONG_TXT, LONG_BB, LONG_TOKENS, LONG_SEED = 410, 100, 10240, 5
LONG_STEPS = 3        # timed steps per bucket, after each bucket's first
LONG_MAX_STEPS = 48   # the stream must give every bucket 1 + LONG_STEPS
# dropout 0, one step per bucket, "pallas" (#1 or #4 forward, the eager
# recompute backward) against "xla" (eager): |loss difference|, grad norm
# (relative), and the deepest layer's (layer 0's) Q, K and V projection
# gradients in relative norm; set before the first run to the train
# phase's limits for the mlm step (whose kernel path also replaced the
# backward)
LONG_LIMITS = (STEP_LOSS_TOL, STEP_NORM_RTOL, STEP_QKV_RTOL)


def long_corpus(cfg, seed):
    """Long captions, as pretrain.py reads them with --max_txt_len 410: 768
    paired captions of 3..200 words a language over 96 images of 10..100
    regions, and 512 of 3..45 words over 64 images of 10..36 regions (so
    that the L = 174 bucket fills its batches of 56 about as often as the
    others fill theirs); texts of more than 410 tokens are dropped."""
    return merge_corpora(
        [synth_pretrain_corpus(seed, n_imgs=96, txt_per_img=8,
                               vocab=cfg.vocab_size, img_dim=cfg.img_dim,
                               max_words=200),
         synth_pretrain_corpus(seed + 1, n_imgs=64, txt_per_img=8,
                               vocab=cfg.vocab_size, img_dim=cfg.img_dim,
                               max_bb=36, max_words=45)],
        vocab=cfg.vocab_size, max_txt_len=LONG_TXT)


def merge_corpora(parts, **txt_kw):
    """One (MemTxtDb, MemImgDb) of several, names prefixed by part."""
    records, feats = {}, {}
    for i, (txt, img) in enumerate(parts):
        for name, rec in txt.records.items():
            records[f"{i}/{name}"] = dict(rec,
                                          img_fname=f"{i}/{rec['img_fname']}")
        feats.update({f"{i}/{k}": f for k, f in img.feats.items()})
    return MemTxtDb(records, **txt_kw), MemImgDb(feats)


def phase_long(card):
    """Long-caption mlm steps at full width, fed by MetaLoader ->
    PrefetchLoader: under "pallas" at dropout 0.1 (#5 and #6's two
    passes), then one step per bucket at dropout 0 (#1 or #4) against the
    eager path; returns the launches of #4 and the first batch of the
    L = 512 bucket."""
    print("== long captions: uc2-base mlm steps on the card at joint L = 174 "
          "/ 339 / 512 under \"pallas\" (dropout 0.1, config/uc2_pretrain.json "
          "optimizer), batches from MetaLoader -> PrefetchLoader")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention="pallas")
    t0 = time.perf_counter()
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    txt_db, img_db = long_corpus(cfg, LONG_SEED)
    task = TaskLoader("mlm", datasets.MlmDataset(txt_db, img_db),
                      default_buckets(LONG_TXT, LONG_BB, LONG_TOKENS),
                      seed=LONG_SEED)
    specs = task.buckets
    bucket_of = {s.joint_len: i for i, s in enumerate(specs)}
    print(f"  model and corpus ({len(txt_db.ids)} of {len(txt_db.records)} "
          f"captions within {LONG_TXT} tokens) ready in "
          f"{time.perf_counter() - t0:.1f} s; buckets (Lt, Nb, B, M) "
          f"{[(s.txt_len, s.num_bb, s.batch_size, s.max_masked) for s in specs]}")
    layers = cfg.num_hidden_layers
    opt = pretrain_optimizer(model)
    rng = DropoutRng(TRAIN_SEED, "cuda")
    runs = [dict(times=[], peak=0.0, stats=[], bad=0) for _ in specs]
    first = {}
    pre = PrefetchLoader(MetaLoader({"mlm": task}, seed=LONG_SEED), depth=2,
                         device_put=task_batch_to_device("cuda"))
    order = []
    torch.cuda.synchronize()
    reset_launches()
    try:
        while min(len(r["times"]) for r in runs) < 1 + LONG_STEPS:
            if len(order) == LONG_MAX_STEPS:
                fatal(f"{LONG_MAX_STEPS} steps gave a bucket fewer than "
                      f"{1 + LONG_STEPS} batches: {[len(r['times']) for r in runs]}")
            _, batch = next(pre)
            L = batch["attn_mask"].shape[1]
            bi = bucket_of[L]
            order.append(bi)
            first.setdefault(bi, batch)
            before = launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            met = train_step(model, opt, batch, rng)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            after = launch_counts()
            want = no_launches()
            want.update({k.__name__: layers for k in TRAIN_KERNELS})
            r = runs[bi]
            r["bad"] += {k: after[k] - before[k] for k in after} != want
            r["times"].append(ms)
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated() / 2 ** 30)
            r["stats"].append((met["loss"].item(), met["grad_norm"].item(),
                               met["n_units"].item()))
    finally:
        pre.close()
    counts = launch_counts()
    print(f"  {len(order)} steps in the stream's order (bucket per step): "
          f"{order}")
    for spec, r in zip(specs, runs):
        L = spec.joint_len
        ms = sum(r["times"][1:]) / (len(r["times"]) - 1)
        print(f"  L={L} B={spec.batch_size} M={spec.max_masked}: {ms:.3f} "
              f"ms/step = {spec.batch_size / ms * 1e3:.1f} examples/s over "
              f"{len(r['times']) - 1} steps (first {r['times'][0]:.1f} ms; "
              f"steps {', '.join(f'{t:.2f}' for t in r['times'][1:])}), peak "
              f"memory {r['peak']:.2f} GiB [{card}]")
        print(f"    loss / grad norm / slots per step: " + "; ".join(
            f"{a:.4f} / {b:.4f} / {int(c)}" for a, b, c in r["stats"]))
        print(f"    launches per step: {layers} each of #5 and #6's two "
              f"passes, no other kernel: "
              f"{'ok' if not r['bad'] else 'FAIL'} ({r['bad']} steps off)")
        if r["bad"]:
            fail(f"long captions, L={L}: launches are not {layers} each of "
                 f"#5 and #6's two passes a step")
        if not all(np.isfinite(x) for s in r["stats"] for x in s[:2]):
            fail(f"long captions, L={L}: a loss or grad norm is not finite")
    print(f"  launches over the run {counts}")

    # a bitwise repeat of one L = 512 step
    batch = first[bucket_of[specs[-1].joint_len]]
    res = []
    for _ in range(2):
        model.load_state_dict(start)
        m = train_step(model, pretrain_optimizer(model), batch,
                       DropoutRng(7, "cuda"))
        res.append((m["loss"], m["grad_norm"]))
    same = all(torch.equal(a, b) for a, b in zip(*res))
    print(f"  repeat of one L={specs[-1].joint_len} step (same weights and "
          f"seeds): loss {res[0][0].item():.6f} / {res[1][0].item():.6f}, grad "
          f"norm {res[0][1].item():.6f} / {res[1][1].item():.6f}; bitwise "
          f"equal: {same}")
    if not same:
        fail("one long-caption step with the same seeds is not bitwise "
             "repeatable")
    del model, opt
    torch.cuda.empty_cache()

    # dropout 0: one step per bucket, "pallas" against "xla"; then the
    # kernel path's ms/step on the same batch
    cfg0 = cfg.replace(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    paths = {impl: UC2ForPretraining(cfg0.replace(use_pallas_attention=impl),
                                     device="cuda", seed=0)
             for impl in ("pallas", "xla")}
    loss_tol, norm_rtol, qkv_rtol = LONG_LIMITS
    lr = 4e-5
    reset_launches()
    for bi, spec in enumerate(specs):
        L = spec.joint_len
        out = {}
        for impl, m_ in paths.items():
            m_.load_state_dict(start)
            m_.zero_grad(set_to_none=True)
            opt = build_optimizer(m_, constant(lr), weight_decay=0.01,
                                  betas=(0.9, 0.98), grad_norm=5.0)
            rng0 = DropoutRng(0, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = launch_counts()
            met = train_step(m_, opt, first[bi], rng0)
            qkv = [g.clone() for g in
                   m_.roberta.layer[0].attention.qkv.weight.grad.split(H)]
            times = []
            for _ in range(LONG_STEPS if impl == "pallas" else 0):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                train_step(m_, opt, first[bi], rng0)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            after = launch_counts()
            out[impl] = (met["loss"].item(), met["grad_norm"].item(), qkv,
                         {k: after[k] - before[k] for k in after}, times,
                         torch.cuda.max_memory_allocated() / 2 ** 30)
            del opt
        (lk, nk, gk, ck, times, peak), (le, ne, ge, ce, _, _) = out.values()
        want = no_launches()
        want["flash_attention_long" if uses_long_kernel(N, L)
             else "flash_attention"] = layers * (1 + LONG_STEPS)
        rel = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, ge)]
        ok = (abs(lk - le) <= loss_tol and abs(nk - ne) <= norm_rtol * ne
              and max(rel) <= qkv_rtol and ck == want and ce == no_launches())
        print(f"  L={L}, one step at dropout 0, kernel path (\"pallas\": "
              f"{ck['flash_attention']} launches of #1, "
              f"{ck['flash_attention_long']} of #4 over {1 + LONG_STEPS} "
              f"steps) vs eager (\"xla\"): loss "
              f"{lk:.6f} vs {le:.6f} (|diff| {abs(lk - le):.3e}), grad norm "
              f"{nk:.6f} vs {ne:.6f} (relative {abs(nk - ne) / ne:.3e}), "
              f"layer 0's ||dW - dW_eager|| / ||dW_eager|| of Q / K / V "
              f"{rel[0]:.3e} / {rel[1]:.3e} / {rel[2]:.3e} (tolerance: loss "
              f"{loss_tol:g}, grad norm {norm_rtol:g} relative, Q/K/V "
              f"{qkv_rtol:.3e}; launches {layers} a step of "
              f"{'#4' if uses_long_kernel(N, L) else '#1'}) "
              f"{'ok' if ok else 'FAIL'}")
        ms = sum(times) / len(times)
        print(f"    kernel path at dropout 0: {ms:.3f} ms/step = "
              f"{spec.batch_size / ms * 1e3:.1f} examples/s over {len(times)} "
              f"steps after the compared one (steps "
              f"{', '.join(f'{t:.2f}' for t in times)}), peak memory "
              f"{peak:.2f} GiB [{card}]")
        if not ok:
            fail(f"long captions, L={L}: the dropout-0 kernel step disagrees "
                 f"with the eager step or launched other kernels")
    zero = launch_counts()
    print(f"  launches over the dropout-0 steps {zero}")
    del paths
    torch.cuda.empty_cache()
    return ({"flash_attention_long": zero["flash_attention_long"]},
            first[bucket_of[specs[-1].joint_len]])


# ------------------------------------------- the UC2_ATTN_V2 and flash routes
ROUTE_ROWS = {
    "fused_attn_block_v2": dict(
        name="fused_attn_block_v2", route="cuda",
        source="uc2_torch/csrc/fused_attn_block_v2.cu",
        replaces="uc2_tpu/ops/fused_block.py:138"),
    "segment_flash_fwd": dict(
        name="segment_flash_fwd", route="cuda",
        source="uc2_torch/csrc/attention_segment.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:342"),
    "segment_flash_bwd_dq": dict(
        name="segment_flash_bwd_dq", route="cuda",
        source="uc2_torch/csrc/attention_segment.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:1146"),
    "segment_flash_bwd_dkdv": dict(
        name="segment_flash_bwd_dkdv", route="cuda",
        source="uc2_torch/csrc/attention_segment.cu",
        replaces="jax/experimental/pallas/ops/tpu/flash_attention.py:796"),
}


def fill_row(row, tag, kern, plain, nbytes, flops, library_ms=None,
             library="none (no single PyTorch call computes it)"):
    """Time a kernel and its plain version into its JSON row."""
    row.update(ms=time_ms(kern), plain_ms=time_ms(plain, iters=5),
               library_ms=library_ms)
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops)
    lib = library if library_ms is None else f"{library_ms:.4f} ms"
    print(f"    {row['name']} {tag}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library {lib}, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})")


def sdpa_segment_inputs(q, k, v, bias, g=None):
    """The yardstick's inputs: q, k, v (and g) zero-padded to Lp as
    [B, n, Lp, d] and a boolean mask of segment equality [B, 1, Lp, Lp],
    as the library kernel sees them."""
    L = q.shape[1]
    Lp = padded_len(L)

    def pad(t):
        return F.pad(t, (0, 0, 0, 0, 0, Lp - L)).transpose(1, 2).contiguous()
    seg = F.pad(bias[:, 0, 0] >= -1.0, (0, Lp - L), value=False)
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    return (*(pad(t) for t in (q, k, v)), mask, None if g is None else pad(g))


# #12 at the edges of its 128-key blocks and 64-row query tiles: first key
# blocks masked for whole valid rows ("leading": keys 0..127 invalid) or
# for the invalid rows ("first_block": keys from 128 on invalid)
SEGMENT_EDGES = ((1, 128, "first_block"), (2, 129, "leading"),
                 (3, 255, "leading"), (1, 256, "first_block"),
                 (2, 257, "leading"), (3, 512, "first_block"))


# #12a's 64-key tile edges that are not edges of the library's 128-key
# blocks (its sweep stops at the last 64-key tile holding a key < L, short
# of the padded length), in every mask case: every key valid, all but the
# first 10 invalid, and the first key block masked for whole rows
DQ_EDGES = tuple((1 + i % 3, L, case) for i, (L, case) in enumerate(
    (L, case) for L in (129, 192, 200, 255)
    for case in ("valid", "invalid", "leading", "first_block")))


def segment_edge_bias(b, L, case):
    keys = torch.arange(L, device="cuda")[None].expand(b, L)
    valid = {"valid": keys >= 0, "invalid": keys < 10,
             "leading": keys >= 128, "first_block": keys < 128}[case]
    return ((~valid).float() * -10000.0)[:, None, None, :].contiguous()


def time_segment_fwd(q, k, v, bias, card):
    """#12 replayed from a CUDA graph beside SDPA with a boolean segment
    mask on the padded tensors, also from a graph; returns SDPA's chained
    ms."""
    qp, kp, vp, mask, _ = sdpa_segment_inputs(q, k, v, bias)
    sdpa = lambda: F.scaled_dot_product_attention(qp, kp, vp, attn_mask=mask)
    kern = lambda: segment_flash_fwd(q, k, v, bias)
    b, L = q.shape[:2]
    ms, g_ms, lib, lib_g = (time_ms(kern), graph_ms(kern), time_ms(sdpa),
                            graph_ms(sdpa))
    print(f"    #12 B={b} L={L}: kernel {ms:.4f} ms (graph {g_ms:.4f}), SDPA "
          f"with a segment mask {lib:.4f} ms (graph {lib_g:.4f}); from "
          f"graphs kernel / SDPA {g_ms / lib_g:.2f} [{card}]")
    return lib


def time_segment_bwd(q, k, v, bias, g, card):
    """#12a and #12b on the forward's output and statistics, each chained
    and replayed from a CUDA graph, beside SDPA's autograd backward with a
    boolean segment mask on the padded tensors (the pair's yardstick;
    chained, and from a graph with its forward on a side stream); returns
    SDPA's chained ms."""
    out, st = segment_flash_fwd(q, k, v, bias)
    _, di = segment_flash_bwd_dq(q, k, v, bias, out, g, st)
    b, L = q.shape[:2]
    for name, kern in (
            ("#12a", lambda: segment_flash_bwd_dq(q, k, v, bias, out, g, st)),
            ("#12b", lambda: segment_flash_bwd_dkdv(q, k, v, bias, g, st,
                                                    di))):
        print(f"    {name} B={b} L={L}: kernel {time_ms(kern):.4f} ms (graph "
              f"{graph_ms(kern):.4f}) [{card}]")
    qp, kp, vp, mask, gp = sdpa_segment_inputs(q, k, v, bias, g)
    qp, kp, vp = (t.requires_grad_(True) for t in (qp, kp, vp))
    side = torch.cuda.Stream()      # the forward on a side stream, so that
    side.wait_stream(torch.cuda.current_stream())    # its backward can be
    with torch.cuda.stream(side):                    # captured
        sd_out = F.scaled_dot_product_attention(qp, kp, vp, attn_mask=mask)
    torch.cuda.current_stream().wait_stream(side)

    def lib():
        return torch.autograd.grad(sd_out, (qp, kp, vp), gp, retain_graph=True)
    lib_ms = time_ms(lib)
    try:
        lib_g = f"{graph_ms(lib, stream=side):.4f}"
    except RuntimeError as e:
        lib_g = f"not captured: {str(e).splitlines()[0]}"
        torch.cuda.synchronize()
    print(f"    SDPA (boolean segment mask, Lp = {padded_len(L)}) autograd "
          f"backward B={b} L={L}: {lib_ms:.4f} ms (graph {lib_g}): the "
          f"yardstick of #12a + #12b together [{card}]")
    return lib_ms


def phase_segment_times(gen, card):
    """``--times``: #12 at (64, 162) and #12a, #12b at (128, 162) as phase
    9 times them."""
    time_segment_fwd(*heads(gen, B, 162), card)
    q, k, v, bias = heads(gen, 128, 162)
    g = torch.randn(128, 162, N, D, generator=gen, device="cuda").bfloat16()
    time_segment_bwd(q, k, v, bias, g, card)


def phase_route_kernels(gen, card):
    """#7 against its plain version at the fused scoring buckets (B = 64,
    L = 128, 162), timed beside v1chain, and at BLOCK_EDGES; #12 at (64, 128), (64, 162) and (16, 512); #12a and #12b
    each against its plain version on the same inputs at the "flash" mlm
    shapes (160, 128), (128, 162), (16, 512), the autograd Function (all
    three kernels) against the plain backward, and a bitwise repeat. The
    rows' times are those of (64, 162) for #7 and #12 and (128, 162) for
    #12a and #12b."""
    print("== route kernels vs plain (#7 the block with the QKV projection "
          "inside; #12 / #12a / #12b the \"flash\" route's segment-masked "
          "attention; plain: fp32 compute on the same bf16 inputs)")
    rows = {k: dict(v) for k, v in ROUTE_ROWS.items()}
    weights = v2_weights(gen)
    time_v2(rows, gen, weights, report=True)
    v2_edges(rows, gen, weights)
    fwd = rows["segment_flash_fwd"]
    for b, L in ((B, 128), (B, 162), (16, 512)):
        q, k, v, bias = heads(gen, b, L)
        (out, st), (pout, pst) = (f(q, k, v, bias) for f in (
            segment_flash_fwd, segment_flash_plain))
        tag = f"B={b} L={L}"
        err = max(compare(f"#12 {tag}", out, pout),
                  compare(f"#12 row max {tag}", st[0], pst[0]),
                  compare(f"#12 row sum {tag}", st[1], pst[1]))
        fwd["max_abs_err"] = max(fwd.get("max_abs_err", 0.0), err)
        repeat_bitwise(f"#12 {tag}", lambda: segment_flash_fwd(q, k, v, bias),
                       (out, st))
        if (b, L) == (B, 162):
            fill_row(fwd, tag, lambda: segment_flash_fwd(q, k, v, bias),
                     lambda: segment_flash_plain(q, k, v, bias),
                     4 * b * L * H * 2 + b * L * 4 + 2 * b * N * L * 4,
                     4 * b * N * L * L * D,
                     time_segment_fwd(q, k, v, bias, card))
    for b, L, case in SEGMENT_EDGES:
        q, k, v, _ = heads(gen, b, L)
        bias = segment_edge_bias(b, L, case)
        (out, st), (pout, pst) = (f(q, k, v, bias) for f in (
            segment_flash_fwd, segment_flash_plain))
        tag = f"B={b} L={L} {case}"
        err = max(compare(f"#12 {tag}", out, pout),
                  compare(f"#12 row max {tag}", st[0], pst[0]),
                  compare(f"#12 row sum {tag}", st[1], pst[1]))
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        repeat_bitwise(f"#12 {tag}", lambda: segment_flash_fwd(q, k, v, bias),
                       (out, st))
    dq_row, kv_row = rows["segment_flash_bwd_dq"], rows["segment_flash_bwd_dkdv"]
    for b, L in ((160, 128), (128, 162), (16, 512)):
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        tag = f"B={b} L={L}"
        pout, pst = segment_flash_plain(q, k, v, bias)
        dq, di = segment_flash_bwd_dq(q, k, v, bias, pout, g, pst)
        pdq, pdi = segment_flash_bwd_dq_plain(q, k, v, bias, pout, g, pst)
        e1 = max(compare(f"#12a dq {tag}", dq, pdq),
                 compare(f"#12a di {tag}", di, pdi))
        dk, dv = segment_flash_bwd_dkdv(q, k, v, bias, g, pst, pdi)
        pdk, pdv = segment_flash_bwd_dkdv_plain(q, k, v, bias, g, pst, pdi)
        e2 = max(compare(f"#12b dk {tag}", dk, pdk),
                 compare(f"#12b dv {tag}", dv, pdv))
        dq_row["max_abs_err"] = max(dq_row.get("max_abs_err", 0.0), e1)
        kv_row["max_abs_err"] = max(kv_row.get("max_abs_err", 0.0), e2)
        # the three kernels through autograd against the plain backward,
        # the summed gradients in relative norm as #6's
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        segment_flash_attention(*leaves, bias).backward(g)
        for nm, a, want in zip(("dq", "dk", "dv"), (t.grad for t in leaves),
                               (pdq, pdk, pdv)):
            compare_norm(f"#12 -> #12a/#12b autograd {nm} {tag}", a, want,
                         1e-3)
        again = segment_flash_bwd_dq(q, k, v, bias, pout, g, pst)
        again += segment_flash_bwd_dkdv(q, k, v, bias, g, pst, pdi)
        same = all(torch.equal(a, w_) for a, w_ in zip((dq, di, dk, dv),
                                                       again))
        print(f"  #12a/#12b {tag}: two calls bitwise equal: {same}")
        if not same:
            fail(f"#12a/#12b at {tag} are not bitwise repeatable")
        if (b, L) != (128, 162):
            continue
        lib = time_segment_bwd(q, k, v, bias, g, card)
        act = b * L * H * 2
        vecs = b * L * 4 + 3 * b * N * L * 4     # bias, m, l, di
        fill_row(dq_row, tag,
                 lambda: segment_flash_bwd_dq(q, k, v, bias, pout, g, pst),
                 lambda: segment_flash_bwd_dq_plain(q, k, v, bias, pout, g,
                                                    pst),
                 6 * act + vecs, 6 * b * N * L * L * D, lib,
                 library="SDPA autograd backward (the pair's yardstick)")
        fill_row(kv_row, tag,
                 lambda: segment_flash_bwd_dkdv(q, k, v, bias, g, pst, pdi),
                 lambda: segment_flash_bwd_dkdv_plain(q, k, v, bias, g, pst,
                                                      pdi),
                 6 * act + vecs, 8 * b * N * L * L * D, lib)
    # #12a and #12b at #12's edges: first key blocks masked for whole rows,
    # the edges of #12b's 64-key tiles; each call repeated bit for bit
    for b, L, case in SEGMENT_EDGES:
        q, k, v, _ = heads(gen, b, L)
        bias = segment_edge_bias(b, L, case)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        pout, pst = segment_flash_plain(q, k, v, bias)
        tag = f"B={b} L={L} {case}"
        dq, di = segment_flash_bwd_dq(q, k, v, bias, pout, g, pst)
        pdq, pdi = segment_flash_bwd_dq_plain(q, k, v, bias, pout, g, pst)
        e1 = max(compare(f"#12a dq {tag}", dq, pdq),
                 compare(f"#12a di {tag}", di, pdi))
        got = segment_flash_bwd_dkdv(q, k, v, bias, g, pst, pdi)
        pdk, pdv = segment_flash_bwd_dkdv_plain(q, k, v, bias, g, pst, pdi)
        e2 = max(compare(f"#12b dk {tag}", got[0], pdk),
                 compare(f"#12b dv {tag}", got[1], pdv))
        dq_row["max_abs_err"] = max(dq_row["max_abs_err"], e1)
        kv_row["max_abs_err"] = max(kv_row["max_abs_err"], e2)
        repeat_bitwise(f"#12b {tag}", lambda: segment_flash_bwd_dkdv(
            q, k, v, bias, g, pst, pdi), got)
    for b, L, case in DQ_EDGES:
        q, k, v, _ = heads(gen, b, L)
        bias = segment_edge_bias(b, L, case)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        pout, pst = segment_flash_plain(q, k, v, bias)
        tag = f"B={b} L={L} {case}"
        got = segment_flash_bwd_dq(q, k, v, bias, pout, g, pst)
        pdq, pdi = segment_flash_bwd_dq_plain(q, k, v, bias, pout, g, pst)
        dq_row["max_abs_err"] = max(dq_row["max_abs_err"],
                                    compare(f"#12a dq {tag}", got[0], pdq),
                                    compare(f"#12a di {tag}", got[1], pdi))
        repeat_bitwise(f"#12a {tag}", lambda: segment_flash_bwd_dq(
            q, k, v, bias, pout, g, pst), got)
    return rows


def route_gallery(cfg, seed):
    """A gallery that fills each region-count bucket with one batch: B
    images a bucket (region counts uniform inside it), one caption each;
    3 B texts x 3 scored batches per text."""
    parts, lo = [], 10
    for hi in retrieval.bucket_edges(TXT_LEN, NUM_BB):
        parts.append(synth_gallery(seed + hi, n_imgs=B, txt_per_img=1,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim,
                                   min_bb=lo, max_bb=hi))
        lo = hi + 1
    return merge_corpora(parts, vocab=cfg.vocab_size)


def phase_routes(card):
    """full_retrieval_eval at full width under the two routes: "pallas"
    with UC2_ATTN_V2=1 (#7 at L >= 128, #1 below, #3 everywhere) and
    "flash" (#12 at L >= 128, the eager chain below, no fused block); one
    batch per bucket against the eager path, and pairs/s per bucket beside
    the default route ("pallas" without UC2_ATTN_V2). Returns the
    launches of #7, #12 and #3."""
    print("== routes: uc2-base full_retrieval_eval with UC2_ATTN_V2=1 under "
          "\"pallas\" (#7) and under \"flash\" (#12)")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention=True)
    t0 = time.perf_counter()
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    others = {}
    for impl in ("flash", False):
        others[impl] = UC2ForImageTextRetrieval(
            cfg.replace(use_pallas_attention=impl), device="cuda")
        others[impl].load_state_dict(model.state_dict())
    flash, plain = others["flash"], others[False]
    txt_db, img_db = route_gallery(cfg, seed=3)
    n_txt, nbbs = len(txt_db.ids), list(img_db.name2nbb.values())
    edges, per_bucket, batches = bucket_batches(n_txt, nbbs)
    L_of = [TXT_LEN + e for e in edges]
    print(f"  models and gallery ({len(nbbs)} images, {n_txt} texts; "
          f"buckets L={L_of}: {per_bucket.tolist()} images, {batches} "
          f"scored batches of {B}) ready in {time.perf_counter() - t0:.1f} s")
    if (per_bucket != B).any():
        fatal(f"the routes' gallery does not give each bucket {B} images")
    layers = cfg.num_hidden_layers
    fused = [fused_block_profitable(L, N) for L in L_of]
    want = {"v2": dict(
        flash_attention=layers * sum(nb for nb, f in zip(batches, fused)
                                     if not f),
        fused_attn_block_v2=layers * sum(nb for nb, f in zip(batches, fused)
                                         if f),
        fused_ffn_block=layers * sum(nb for nb, L in zip(batches, L_of)
                                     if fused_ffn_profitable(L))),
        "flash": dict(segment_flash_fwd=layers * sum(
            nb for nb, L in zip(batches, L_of) if L >= STOCK_FLASH_MIN_LEN))}
    launched = {}
    for route, mod, v2 in (("v2", model, "1"), ("flash", flash, None)):
        expect = no_launches()
        expect.update(want[route])
        with env_set("UC2_ATTN_V2", v2):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, (m, txt_ids, img_ids) = retrieval.full_retrieval_eval(
                mod, txt_db, img_db, TXT_LEN, NUM_BB, batch_size=B,
                return_matrix=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched[route] = launch_counts()
        print(f"  {route}: launches {launched[route]}, expected {expect}")
        if launched[route] != expect:
            fail(f"{route}: launch counts do not match the routing")
        if m.shape != (n_txt, len(nbbs)) or not np.isfinite(m).all():
            fail(f"{route}: score matrix is {m.shape} or not finite")
        print(f"  {route}: R@K {json.dumps(metrics)}; eval wall {wall:.2f} s "
              f"for {sum(batches)} batches ({sum(batches) * B / wall:.1f} "
              f"pairs/s) [{card}]")
        bucket_of = np.searchsorted(edges, [img_db.name2nbb[i]
                                            for i in img_ids])
        col = {im: j for j, im in enumerate(img_ids)}
        for bi, nb in enumerate(edges):
            ids_b = [im for im, bk in zip(img_ids, bucket_of) if bk == bi]
            batch, n = bucket_batch(img_db, ids_b, txt_db, txt_ids[0], nb)
            with env_set("UC2_ATTN_V2", v2):
                s_k = mod.scores(batch)[:n]
            s_p = plain.scores(batch)[:n]
            in_matrix = torch.from_numpy(m[0, [col[i] for i in ids_b[:n]]])
            d_kp = (s_k - s_p).abs().max().item()
            d_mat = (s_k.cpu() - in_matrix).abs().max().item()
            print(f"  {route} L={TXT_LEN + nb}: |kernel - eager bf16| "
                  f"{d_kp:.4e}, |batch - matrix| {d_mat:.4e} (tolerance "
                  f"{SCORE_TOL})")
            if not (d_kp <= SCORE_TOL and d_mat <= SCORE_TOL):
                fail(f"{route}: scores at L={TXT_LEN + nb} disagree")
            # in turns: default route, this route, this route, default
            times = {}
            for which in ("default", route, route, "default"):
                with env_set("UC2_ATTN_V2", v2 if which == route else None):
                    fn = model if which == "default" else mod
                    times.setdefault(which, []).append(time_ms(
                        lambda: fn.scores(batch), iters=5))
            print(f"  {route} L={TXT_LEN + nb}: " + "; ".join(
                f"{w_} " + ", ".join(f"{t:.3f}" for t in ts) + " ms/batch = "
                + ", ".join(f"{B / t * 1e3:.1f}" for t in ts) + " pairs/s"
                for w_, ts in times.items()) + f" [{card}]")
    ids_98 = [im for im, bk in zip(img_ids, bucket_of) if bk == 0]
    batch, n = bucket_batch(img_db, ids_98, txt_db, txt_ids[0], edges[0])
    fuse_all = fuse_all_route(card, model, plain, batch, n, layers)
    del model, others, flash, plain
    torch.cuda.empty_cache()
    return {"fused_attn_block_v2": launched["v2"]["fused_attn_block_v2"]
            + fuse_all["fused_attn_block_v2"],
            "segment_flash_fwd": launched["flash"]["segment_flash_fwd"],
            "fused_ffn_block": launched["v2"]["fused_ffn_block"]
            + fuse_all["fused_ffn_block"],
            "fused_attn_block": fuse_all["fused_attn_block"]}


def fuse_all_route(card, model, plain, batch, n, layers):
    """The L = 98 batch with UC2_FUSE_ATTN_ALL=1 (the reference's switch
    that fuses the attention block at every L): 12 launches of #2 (of #7
    with UC2_ATTN_V2=1) and #3, none of #1; scores against the eager path;
    ms/batch in turns with the default route (#1 and the eager
    out-projection). Returns the checked batches' launches."""
    L = batch["attn_mask"].shape[1]
    s_p = plain.scores(batch)[:n]
    counted = dict.fromkeys(("fused_attn_block", "fused_attn_block_v2",
                             "fused_ffn_block"), 0)
    for v2, block in ((None, "fused_attn_block"), ("1", "fused_attn_block_v2")):
        expect = no_launches()
        expect.update({block: layers, "fused_ffn_block": layers})
        with env_set("UC2_FUSE_ATTN_ALL", "1"), env_set("UC2_ATTN_V2", v2):
            reset_launches()
            s_k = model.scores(batch)[:n]
            torch.cuda.synchronize()
            got = launch_counts()
            tag = f"UC2_FUSE_ATTN_ALL=1{' UC2_ATTN_V2=1' if v2 else ''} L={L}"
            d = (s_k - s_p).abs().max().item()
            print(f"  {tag}: launches {got}, expected {expect}; |kernel - "
                  f"eager bf16| {d:.4e} (tolerance {SCORE_TOL})")
            if got != expect:
                fail(f"{tag}: launch counts do not match the routing")
            if not d <= SCORE_TOL:
                fail(f"{tag}: scores disagree with the eager path")
            for k in counted:
                counted[k] += got[k]
        times = {}
        for which in ("default", tag, tag, "default"):
            on = "1" if which == tag else None
            with env_set("UC2_FUSE_ATTN_ALL", on), env_set(
                    "UC2_ATTN_V2", v2 if on else None):
                times.setdefault(which, []).append(time_ms(
                    lambda: model.scores(batch), iters=5))
        print(f"  {tag}: " + "; ".join(
            f"{w_} " + ", ".join(f"{t:.3f}" for t in ts) + " ms/batch = "
            + ", ".join(f"{B / t * 1e3:.1f}" for t in ts) + " pairs/s"
            for w_, ts in times.items()) + f" [{card}]")
    return counted


# "flash" training at attention dropout 0 (hidden dropout 0.1): the mlm
# buckets at L = 128 and 162 (bench.py TRAIN_BUCKETS) and the long-caption
# bucket at L = 512 (Lp = L)
FLASH_STEPS = 2       # timed steps per shape and route, after one warm-up


def phase_flash_train(card, long_batch):
    """mlm steps under "flash" at attention dropout 0: 12 launches each of
    #12, #12a and #12b a step, finite losses, a bitwise repeat, one step
    against the eager path at dropout 0; ms/step beside "pallas" (#1 or #4
    with the eager-recompute backward at rate 0) and "pallas-train" (#5 /
    #6 at rate 0) on the same batches. Returns the launches of #12, #12a
    and #12b over the "flash" steps."""
    print("== flash train: uc2-base mlm steps under \"flash\" at attention "
          "dropout 0 (hidden dropout 0.1, config/uc2_pretrain.json optimizer)")
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", attention_probs_dropout_prob=0.0)
    t0 = time.perf_counter()
    paths = {impl: UC2ForPretraining(cfg.replace(use_pallas_attention=impl),
                                     device="cuda", seed=0)
             for impl in ("flash", "pallas", "pallas-train")}
    start = {k: v.clone() for k, v in paths["flash"].state_dict().items()}
    txt_db, img_db = synth_gallery(seed=1, n_imgs=N_IMGS, txt_per_img=2,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    n_steps = 1 + FLASH_STEPS
    shapes = [(160, 128, mlm_batches(txt_db, img_db, 36, 66, 160, n_steps,
                                     seed=66)[0]),
              (128, 162, mlm_batches(txt_db, img_db, 66, 100, 128, n_steps,
                                     seed=100)[0]),
              (long_batch["attn_mask"].shape[0],
               long_batch["attn_mask"].shape[1], [long_batch] * n_steps)]
    print(f"  models and batches ready in {time.perf_counter() - t0:.1f} s")
    layers = cfg.num_hidden_layers
    total = dict.fromkeys((k.__name__ for k in SEGMENT_KERNELS), 0)
    for b, L, batches in shapes:
        times = {}
        for impl in ("pallas", "flash", "flash", "pallas-train"):
            m_ = paths[impl]
            m_.load_state_dict(start)
            opt = pretrain_optimizer(m_)
            rng = DropoutRng(TRAIN_SEED, "cuda")
            torch.cuda.synchronize()
            reset_launches()
            ts, losses = [], []
            for batch in batches:
                t1 = time.perf_counter()
                met = train_step(m_, opt, batch, rng)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t1) * 1e3)
                losses.append((met["loss"].item(), met["grad_norm"].item()))
            m_.zero_grad(set_to_none=True)
            del opt
            counts = launch_counts()
            times.setdefault(impl, []).append(sum(ts[1:]) / FLASH_STEPS)
            if impl != "flash":
                continue
            expect = no_launches()
            expect.update({k.__name__: layers * n_steps
                           for k in SEGMENT_KERNELS})
            for k in SEGMENT_KERNELS:
                total[k.__name__] += counts[k.__name__]
            print(f"  L={L} B={b}, flash run {len(times['flash'])}: loss / "
                  f"grad norm per step "
                  + "; ".join(f"{a:.4f} / {c:.4f}" for a, c in losses)
                  + f"; launches {layers} each of #12, #12a, #12b a step: "
                  f"{'ok' if counts == expect else 'FAIL ' + str(counts)}")
            if counts != expect:
                fail(f"flash train, L={L}: launches are not {layers} each "
                     f"of #12, #12a and #12b a step")
            if not all(np.isfinite(x) for r in losses for x in r):
                fail(f"flash train, L={L}: a loss or grad norm is not finite")
        print(f"  L={L} B={b}, ms/step over {FLASH_STEPS} steps after a "
              f"warm-up, in turns: " + "; ".join(
                  f"{impl} " + ", ".join(f"{t:.3f}" for t in ts)
                  for impl, ts in times.items())
              + f" (= {b / np.mean(times['flash']) * 1e3:.1f} examples/s "
              f"under flash) [{card}]")
    # a bitwise repeat of one step at L = 162
    _, L, batches = shapes[1]
    res = []
    for _ in range(2):
        paths["flash"].load_state_dict(start)
        m = train_step(paths["flash"], pretrain_optimizer(paths["flash"]),
                       batches[0], DropoutRng(7, "cuda"))
        res.append((m["loss"], m["grad_norm"]))
    same = all(torch.equal(a, c) for a, c in zip(*res))
    print(f"  repeat of one L={L} step (same weights and seeds): loss "
          f"{res[0][0].item():.6f} / {res[1][0].item():.6f}, grad norm "
          f"{res[0][1].item():.6f} / {res[1][1].item():.6f}; bitwise equal: "
          f"{same}")
    if not same:
        fail("one flash step with the same seeds is not bitwise repeatable")
    del paths
    torch.cuda.empty_cache()
    # dropout 0 everywhere: one step against the eager path, the mlm step's
    # limits (STEP_*)
    ck = step_vs_eager(cfg.replace(hidden_dropout_prob=0.0), "flash",
                       batches[0], start, L)
    want = {k.__name__: layers for k in SEGMENT_KERNELS}
    if {k: ck[k] for k in want} != want:
        fail(f"flash step at dropout 0: launches {ck}, expected {want}")
    return total


LAB_ROWS = {
    "fused_layer_block": dict(
        name="fused_layer_block", route="cuda",
        source="uc2_torch/csrc/fused_layer_block.cu",
        replaces="uc2_tpu/ops/fused_block.py:326"),
    "attention_bf16_probs": dict(
        name="attention_bf16_probs", route="cuda",
        source="uc2_torch/csrc/attention_stream.cuh",
        replaces="scripts/kernel_lab.py:38"),
}


def repeat_bitwise(what: str, fn, first, times: int = 1):
    """Fail unless each of ``times`` more calls of ``fn`` gives ``first``
    bit for bit."""
    def equal(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)
    same = all(equal(fn(), first) for _ in range(times))
    print(f"  {what}: {times + 1} calls bitwise equal: {same}")
    if not same:
        fail(f"{what} is not bitwise repeatable")


LAYER_SHAPES = ((B, 98), (B, 128), (B, 162), (8, 512))


def layer_weights(gen):
    """#8's weights and vectors at the lab's scales: wo, bo, g1, be1, w1,
    b1, w2, b2, g2, be2."""
    w = lambda *shape: (torch.randn(*shape, generator=gen, device="cuda")
                        * 0.02).bfloat16()
    return (w(H, H), vec(gen, H, 0.01), vec(gen, H, 0.1, 1.0),
            vec(gen, H, 0.1), w(FF, H), vec(gen, FF, 0.01), w(H, FF),
            vec(gen, H, 0.01), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1))


def layer_args(gen, b, L, weights):
    q, k, v, bias = heads(gen, b, L)
    x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
    return (q, k, v, bias, x, *weights)


def layer_split(args):
    """#8's yardstick: #2 then #3 on the same inputs (the lab's split2;
    its FFN adds #2's bf16 output, not x2 in fp32)."""
    q, k, v, bias, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = args
    x2 = fused_attn_block(q, k, v, bias, x, wo, bo, g1, be1)
    return fused_ffn_block(x2, w1, b1, w2, b2, g2, be2)


def time_layer(args, card):
    """#8 and the split #2 + #3, each chained and replayed from a CUDA
    graph, on the same inputs."""
    b, L = args[0].shape[:2]
    one = lambda: fused_layer_block(*args)
    split = lambda: layer_split(args)
    ms, g_ms = time_ms(one), graph_ms(one)
    sp, sp_g = time_ms(split), graph_ms(split)
    print(f"    #8 B={b} L={L}: kernel {ms:.4f} ms (graph {g_ms:.4f}) [{card}]")
    print(f"    #8's yardstick #2 + #3 B={b} L={L}: {sp:.4f} ms (graph "
          f"{sp_g:.4f}); from graphs #8 / split {g_ms / sp_g:.2f} [{card}]")


def phase_layer_times(gen, card):
    """``--times``: #8 at LAYER_SHAPES as phase 12 times it, beside #2 +
    #3 (the split) on the same inputs, each chained and from graphs."""
    weights = layer_weights(gen)
    for b, L in LAYER_SHAPES:
        time_layer(layer_args(gen, b, L, weights), card)


def phase_lab_kernels(gen, card):
    """#8 against its plain version at LAYER_SHAPES, on random weights at
    the lab's scales, each timed chained and from a CUDA graph beside #2 +
    #3 (the split) on the same inputs, with its bound; #11 at (64, 98) and
    (64, 162) on heads that are views into one projection. #8's row holds
    its times at (64, 162), #11's at (64, 162) beside SDPA; each repeated
    bit for bit."""
    print("== lab kernels vs plain (#8 the whole encoder layer; #11 attention "
          "with unnormalised bf16 probabilities; plain: fp32 compute on the "
          "same bf16 inputs)")
    rows = {k: dict(v) for k, v in LAB_ROWS.items()}
    weights = layer_weights(gen)
    for b, L in LAYER_SHAPES:
        args = layer_args(gen, b, L, weights)
        run_case(rows, "fused_layer_block", b, L, fused_layer_block,
                 fused_layer_block_plain, args,
                 5 * b * L * H * 2 + b * L * 4 + (H * H + 2 * H * FF) * 2
                 + (6 * H + FF) * 4,
                 4 * b * N * L * L * D + 2 * b * L * H * H + 4 * b * L * H * FF,
                 report=(b, L) == (B, 162))
        time_layer(args, card)
        repeat_bitwise(f"#8 B={b} L={L}", lambda: fused_layer_block(*args),
                       fused_layer_block(*args))
    for L in (98, 162):
        q, k, v, bias = heads(gen, B, L)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bias16 = bias.bfloat16()
        run_case(rows, "attention_bf16_probs", B, L, attention_bf16_probs,
                 attention_bf16_probs_plain, (q, k, v, bias),
                 4 * B * L * H * 2 + B * L * 4, 4 * B * N * L * L * D,
                 library=lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=bias16),
                 report=L == 162, graph=True)
        repeat_bitwise(f"#11 B={B} L={L}",
                       lambda: attention_bf16_probs(q, k, v, bias),
                       attention_bf16_probs(q, k, v, bias))
    return rows


# the lab's racers by mode, and the largest maxerr each mode may print (set
# before the first run): every output is bf16 and held against the mode's
# eager chain, which rounds at other points. op: attention outputs of up
# to ~4, a few bf16 ulps (2^-6 each) and #11's unnormalised rounding
# (2^-8 of a probability); the blocks: LayerNorm outputs of up to ~5
# (ulp 2^-5) after intermediate sums the eager chain rounds to bf16; ce:
# gradients of up to ~0.25 in bf16 (ulp 2^-10), chunked against full.
LAB_RACERS = {"op": ("v3", "v3bb1", "v3bb4", "v4bf16", "v4qs", "xla", "sdpa"),
              "block": ("fusedblock", "xlablock"),
              "block2": ("v1chain", "v2inkernel"),
              "ffn": ("xlaffn", "fusedffn"),
              "layer": ("xlalayer", "split2", "onekernel"),
              "ce": ("xlace_grad", "chunked8_grad", "matmul_roofline")}
LAB_MAXERR = {"op": 2.0 ** -4, "block": 2.0 ** -2, "block2": 2.0 ** -2,
              "ffn": 2.0 ** -2, "layer": 2.0 ** -2, "ce": 2.0 ** -8}
LAB_ITERS = 10
RESULT_LINE = re.compile(r"^RESULT (\S+): (.*)$")


def phase_lab(card):
    """``python -m uc2_torch.lab`` in every mode at its default shapes
    (through ``lab.main``, output captured and echoed): every racer's RESULT
    line, no FAILED, each maxerr within LAB_MAXERR, #8 launched only by
    the layer mode and #11 only by the op mode. Returns their launches
    and #3's (the ffn and layer modes)."""
    print(f"== lab: uc2_torch.lab, every mode, --iters {LAB_ITERS} [{card}]")
    launched = {}
    for mode in lab.MODES:
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = lab.main(["--mode", mode, "--iters", str(LAB_ITERS)])
        torch.cuda.synchronize()
        out = buf.getvalue()
        print(out, end="")
        launched[mode] = {k.__name__: k.launches for k in LAB_KERNELS
                          + (flash_attention, fused_attn_block,
                             fused_attn_block_v2, fused_ffn_block)}
        print(f"  {mode}: rc {rc}, {time.perf_counter() - t0:.1f} s, "
              f"launches {launched[mode]}")
        results = dict(m.groups() for m in map(RESULT_LINE.match,
                                               out.splitlines()) if m)
        if rc != 0:
            fail(f"lab --mode {mode} exited {rc}")
        for name in LAB_RACERS[mode]:
            res = results.get(name)
            if res is None or res.startswith("FAILED"):
                fail(f"lab --mode {mode}: racer {name}: {res or 'missing'}")
                continue
            err = re.search(r"maxerr=(\S+)", res).group(1)
            if err != "n/a" and not float(err) <= LAB_MAXERR[mode]:
                fail(f"lab --mode {mode}: {name} maxerr {err} above "
                     f"{LAB_MAXERR[mode]}")
    for kern, mode in ((fused_layer_block, "layer"),
                       (attention_bf16_probs, "op")):
        name = kern.__name__
        others = {m: c[name] for m, c in launched.items() if m != mode}
        if launched[mode][name] <= 0 or any(others.values()):
            fail(f"{name} launched {launched[mode][name]} times in {mode} "
                 f"and {others} elsewhere; expected only in {mode}")
    torch.cuda.empty_cache()
    return {"fused_layer_block": launched["layer"]["fused_layer_block"],
            "attention_bf16_probs": launched["op"]["attention_bf16_probs"],
            "fused_ffn_block": sum(c["fused_ffn_block"]
                                   for c in launched.values())}


# ------------------------------------------------ the pretraining driver
PRETRAIN_DIR = os.path.join("build", "pretrain_smoke")
PRETRAIN_IMGS, PRETRAIN_STEPS, PRETRAIN_SAVE = 512, 12, 6
PRETRAIN_EXTRA = []      # more flags of every run (none on the card)


def pretrain_argv(out, corpus, *extra):
    """config/uc2_pretrain.json unchanged but for its stores (the port's
    synthetic en and de corpora), the output directory and a short run:
    12 steps, a restore.ckpt every 6, validation (2 batches a task) at 12,
    a log line every step."""
    with open("config/uc2_pretrain.json") as f:
        cfg = json.load(f)
    en, de = corpus
    train = [dict(spec, db=[(de if spec["name"].endswith("_de") else en)
                            ["txt_db"]], img=[en["img_db"]])
             for spec in cfg["train_datasets"]]
    val = [dict(spec, db=[en["txt_db"]], img=[en["img_db"]])
           for spec in cfg["val_datasets"]]
    return ["--config", "config/uc2_pretrain.json",
            "--train_datasets", json.dumps(train),
            "--val_datasets", json.dumps(val), "--output_dir", out,
            "--num_train_steps", str(PRETRAIN_STEPS),
            "--save_steps", str(PRETRAIN_SAVE),
            "--valid_steps", str(PRETRAIN_STEPS), "--val_batches", "2",
            "--log_steps", "1", *PRETRAIN_EXTRA, *extra]


def run_pretrain(argv):
    """``uc2_torch.pretrain.main`` as ``python -m uc2_torch.pretrain argv``
    runs it, in this process."""
    opts = pretrain.parse_with_config(pretrain.build_parser(), argv)
    pretrain.apply_reference_config_compat(opts, argv)
    return pretrain.main(opts)


def trained_state(run):
    """The run's parameters and the optimizer's moments (AdamW's or
    Adamax's), copied to the host."""
    out = {f"param {k}": v.detach().cpu().clone()
           for k, v in run.model.state_dict().items()}
    for i, st in run.optimizer.state_dict()["state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "exp_inf"):
            if k in st:
                out[f"{k} {i}"] = st[k].detach().cpu().clone()
    return out


def gate_launches(cfg, L):
    """The kernels one deterministic forward of the model ``cfg`` at joint
    length L launches under the reference's gates."""
    want = no_launches()
    layers, n = cfg.num_hidden_layers, cfg.num_attention_heads
    if fused_block_profitable(L, n):
        want["fused_attn_block"] = layers
    else:
        want["flash_attention_long" if uses_long_kernel(n, L)
             else "flash_attention"] = layers
    want["fused_ffn_block"] = layers
    return want


@contextlib.contextmanager
def counted_eval_steps(calls):
    """Wrap the driver's ``eval_step``: each call's launches are read and
    held against the gates at that batch's joint length."""
    orig = train_step_mod.eval_step

    def counted(model, batch, task, **kw):
        torch.cuda.synchronize()
        before = launch_counts()
        out = orig(model, batch, task, **kw)
        torch.cuda.synchronize()
        got = {k: n - before[k] for k, n in launch_counts().items()
               if n != before[k]}
        L = batch["attn_mask"].shape[1]
        want = {k: n for k, n in gate_launches(model.config, L).items() if n}
        calls.append((task, L, got == want))
        if got != want:
            fail(f"pretrain: validation of {task} at L = {L} launched {got}; "
                 f"the gates want {want}")
        return out
    train_step_mod.eval_step = counted
    try:
        yield
    finally:
        train_step_mod.eval_step = orig


def loop_times(run, skip):
    """ms/step and examples/s of the driver's loop between consecutive log
    boundaries (every step here), over the intervals that hold no save or
    validation (those after the steps in ``skip``) and not the first."""
    rows = []
    for (s0, t0, n0), (s1, t1, n1) in zip(run.logs, run.logs[1:]):
        if s0 not in skip:
            rows.append(((t1 - t0) * 1e3 / (s1 - s0), (n1 - n0) / (t1 - t0)))
    return rows


EMBED_CASES = ((2, (208, 100)), (250002, (208, 62)))


def time_embedding_backward(card):
    """The token types' gradient (2 rows, every id one of them) and the
    word table's (2080 copies of the mask token) three ways: PyTorch's
    embedding backward, indexing's sorted index_put_, and the encoder's
    SmallTableLookup (few-row tables only); ms a backward and whether five
    backwards give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, shape in EMBED_CASES:
        table = torch.nn.Embedding(rows, H, device="cuda")
        ids = torch.randint(0, min(rows, 64), shape, generator=gen,
                            device="cuda")
        if rows > 64:
            ids[:, 0], ids[:, -1], ids[:, 5:15] = 0, 2, rows - 1
        g = torch.randn(*shape, H, generator=gen, device="cuda")
        ways = {"embedding": lambda: table(ids),
                "indexing": lambda: table.weight[ids]}
        if rows <= 16:
            ways["SmallTableLookup"] = lambda: SmallTableLookup.apply(
                table.weight, ids)
        out = []
        for name, fwd in ways.items():
            def backward():
                table.weight.grad = None
                fwd().backward(g)
            grads = []
            for _ in range(5):
                backward()
                grads.append(table.weight.grad.clone())
            same = all(torch.equal(x, grads[0]) for x in grads[1:])
            out.append(f"{name} {time_ms(backward):.3f} ms "
                       f"({'repeats' if same else 'DIFFERS'})")
        print(f"  embedding backward, {rows} rows, ids {shape}: "
              f"{'; '.join(out)} [{card}]")


def phase_pretrain(card):
    """``python -m uc2_torch.pretrain --config config/uc2_pretrain.json``
    in this process, on U2S stores the port's synth_corpus writes at the
    reference's widths: an uninterrupted 12-step run, then the same run
    stopped after step 6 and resumed to 12 in one output directory.
    Returns the uninterrupted run's launches."""
    print(f"== pretrain: python -m uc2_torch.pretrain --config "
          f"config/uc2_pretrain.json on U2S stores, uc2-base at full width, "
          f"{PRETRAIN_STEPS} steps, then stopped at {PRETRAIN_SAVE} and "
          f"resumed [{card}]")
    time_embedding_backward(card)
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    try:
        return _phase_pretrain(card)
    finally:
        shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)


def _phase_pretrain(card):
    t0 = time.perf_counter()
    corpus = [synth_corpus(os.path.join(PRETRAIN_DIR, lang),
                           n_imgs=PRETRAIN_IMGS, txt_per_img=2, seed=seed,
                           paired=lang == "de")
              for lang, seed in (("en", 0), ("de", 1))]
    size = sum(os.path.getsize(os.path.join(d, f)) for c in corpus
               for d in c.values() for f in os.listdir(d))
    print(f"  corpus: en (unpaired) and de (paired) stores of "
          f"{PRETRAIN_IMGS} images x 2 captions, 2048-d fp16 features, "
          f"10-100 boxes, 1601 soft-label classes, vocab 250002: "
          f"{size / 1e9:.3f} GB written in {time.perf_counter() - t0:.1f} s; "
          f"native store library {native_build.OUT}")

    # the store's batch read in prefetch, on a fresh database (the files
    # were just written: the reads come from the page cache)
    feats = db.DetectFeatDb(corpus[0]["img_db"])
    names = feats.db.get("__keys__")
    nbytes = sum(len(r) for r in feats.db.batch_get_raw(names))
    t0 = time.perf_counter()
    feats.prefetch(names, cache_cap=len(names))
    dt = time.perf_counter() - t0
    print(f"  DetectFeatDb.prefetch of {len(names)} records "
          f"({nbytes / 1e6:.1f} MB of msgpack): {dt * 1e3:.1f} ms = "
          f"{len(names) / dt:.0f} records/s, {nbytes / 1e6 / dt:.1f} MB/s "
          f"(native thread pool, decode included)")
    del feats

    reads = dict(store_reads)
    whole = os.path.join(PRETRAIN_DIR, "whole")
    calls = []
    torch.cuda.synchronize()
    reset_launches()
    with counted_eval_steps(calls):
        run = run_pretrain(pretrain_argv(whole, corpus))
    torch.cuda.synchronize()
    launches = launch_counts()
    layers = run.model.config.num_hidden_layers
    with open("config/uc2_pretrain.json") as f:
        accum = json.load(f)["gradient_accumulation_steps"]
    want_train = PRETRAIN_STEPS * layers * accum
    train_counts = {k.__name__: launches[k.__name__] for k in TRAIN_KERNELS}
    print(f"  uninterrupted run: {run.step} steps, losses "
          f"{[(s, t, round(v, 4)) for s, t, v in run.losses]}")
    print(f"  validation: {run.val}; {len(calls)} eval batches at joint L "
          f"{sorted({L for _, L, _ in calls})}, "
          f"{sum(ok for _, _, ok in calls)} with the gates' launches")
    print(f"  launches over the run: training kernels {train_counts} "
          f"(want {want_train} each: {PRETRAIN_STEPS} steps x {layers} "
          f"layers x {accum} micro-batches); all {launches}")
    for name, n in train_counts.items():
        if n != want_train:
            fail(f"pretrain: {name} launched {n} times, want {want_train}")
    for k in ("fused_ffn_block_train_fwd", "fused_ffn_block_train_bwd",
              "fused_attn_block_v2", "segment_flash_fwd",
              "fused_layer_block", "attention_bf16_probs"):
        if launches[k]:
            fail(f"pretrain: {k} launched {launches[k]} times off the path")
    if not calls:
        fail("pretrain: validation ran no batch")
    # the driver's validate over the whole validation set, so that both
    # gates' routes run (2 batches a task may all be short)
    opts = pretrain.parse_with_config(pretrain.build_parser(),
                                      pretrain_argv(whole, corpus))
    opts.val_batches = 0
    val, _ = pretrain.build_datasets(opts, "val")
    sweep = []
    t0 = time.perf_counter()
    with counted_eval_steps(sweep):
        logs = pretrain.validate(run.model, val, default_buckets(
            opts.max_txt_len, opts.max_bb, opts.train_batch_size), opts,
            task_batch_to_device(opts.device))
    print(f"  full validation sweep: {len(sweep)} batches at joint L "
          f"{sorted({L for _, L, _ in sweep})} in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(ok for _, _, ok in sweep)} with the gates' launches; {logs}")
    heads = run.model.config.num_attention_heads
    if {fused_block_profitable(L, heads) for _, L, _ in sweep} != {True,
                                                                   False}:
        fail("pretrain: the validation sweep did not run both gates' routes")
    bad = [(s, t, v) for s, t, v in run.losses if not np.isfinite(v)]
    bad += [(k, v) for k, log in run.val.items() for v in log.values()
            if not np.isfinite(v)]
    if bad or len(run.losses) != PRETRAIN_STEPS:
        fail(f"pretrain: non-finite or missing losses {bad}")
    rows = loop_times(run, {PRETRAIN_SAVE, PRETRAIN_STEPS})
    ms = sorted(r[0] for r in rows)
    ex = sorted(r[1] for r in rows)
    print(f"  driver loop: {np.median(ms):.1f} ms/step median "
          f"({ms[0]:.1f}-{ms[-1]:.1f}), {np.median(ex):.1f} examples/s "
          f"median ({ex[0]:.1f}-{ex[-1]:.1f}) over {len(rows)} steps that "
          f"hold no save or validation; per step (ms) "
          f"{[round(r[0], 1) for r in rows]}; the driver's sustained "
          f"{run.sustained} [{card}]")
    size = os.path.getsize(os.path.join(whole, "restore.ckpt"))
    print(f"  restore.ckpt {size / 1e9:.3f} GB (parameters and AdamW's "
          f"moments); saves took {[round(t, 2) for t in run.save_seconds]} s "
          f"(host copy and torch.save)")
    want = trained_state(run)
    want_losses = run.losses
    del run
    shutil.rmtree(whole, ignore_errors=True)
    torch.cuda.empty_cache()

    resumed = os.path.join(PRETRAIN_DIR, "resumed")
    reset_launches()
    first = run_pretrain(pretrain_argv(resumed, corpus, "--stop_after_steps",
                                       str(PRETRAIN_SAVE)))
    first_losses, first_saves = first.losses, first.save_seconds
    del first
    torch.cuda.empty_cache()
    second = run_pretrain(pretrain_argv(resumed, corpus))
    torch.cuda.synchronize()
    counts = launch_counts()
    got = trained_state(second)
    print(f"  resumed run: steps 1-{PRETRAIN_SAVE}, then "
          f"{PRETRAIN_SAVE + 1}-{second.step} after the restore; saves took "
          f"{[round(t, 2) for t in first_saves + second.save_seconds]} s; "
          f"training kernels {[counts[k.__name__] for k in TRAIN_KERNELS]}")
    losses = first_losses + second.losses
    diff = {k: (got[k].float() - want[k].float()).abs().max().item()
            for k in want if not torch.equal(got[k], want[k])}
    loss_diff = [(a, b) for a, b in zip(losses, want_losses) if a != b]
    if diff or loss_diff or len(losses) != len(want_losses):
        worst = max(diff.items(), key=lambda kv: kv[1]) if diff else None
        fail(f"pretrain: the resumed run is not the uninterrupted one bit "
             f"for bit: {len(diff)} tensors differ (largest {worst}), "
             f"losses {loss_diff[:3]}")
    else:
        print(f"  the resumed run equals the uninterrupted one bit for bit: "
              f"{len(want)} parameter and moment tensors, "
              f"{len(losses)} step losses")
    for k in TRAIN_KERNELS:
        if counts[k.__name__] != want_train:
            fail(f"pretrain: the resumed runs launched {k.__name__} "
                 f"{counts[k.__name__]} times, want {want_train}")
    del second
    used = {k: store_reads[k] - reads[k] for k in store_reads}
    print(f"  records read over the three runs: {used}")
    if used["python"] or not used["native"] or native_build._lib is None:
        fail(f"pretrain: the stores were not read through the native "
             f"library only: {used}")
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ the remaining objectives
# the objectives beyond config/uc2_pretrain.json's mix, at its bucket (62
# text tokens, 100 regions, B = 128; tlm-ni text only, L = 62): name ->
# (task, make_loss_fn keywords)
OBJ = {"mmxlm": ("mmxlm", {}), "vmlm-soft": ("vmlm-soft", {}),
       "mmxlm-soft": ("mmxlm-soft", {}), "mrfr": ("mrfr", {}),
       "mrc": ("mrc", {}), "mrc-kl": ("mrc-kl", {}),
       "mrm-nce": ("mrm-nce", {}),
       "itm-ot": ("itm-ot", dict(itm_ot_lambda=0.1)),
       "itm-ot-pos": ("itm-ot", dict(itm_ot_lambda=0.1, ot_pos_only=True)),
       "itm-hard": ("itm", {}), "tlm-ni": ("tlm-ni", {})}
OBJ_REPEAT = ("mrm-nce", "itm-ot")
# dropout 0, one step of the kernel path ("pallas-train" + UC2_FFN_TRAIN=1)
# against the eager path ("xla"): |loss difference|, grad norm (relative)
# and the worst layer's W1 and W2 gradients in relative norm, as
# MIX_LIMITS holds itm and vmlm. Tasks held to the mix's limits where
# their first H100 readings fit them (mmxlm 3.2e-4, 8.7e-5, 1.2e-2;
# vmlm-soft 0, 1.8e-4, 4.5e-3; mrfr 6.2e-6, 7.1e-5, 2.5e-3; mrc-kl 7.3e-9,
# 3.4e-4, 4.6e-3; itm on hard negatives 3.0e-5, 1.0e-3, 1.0e-2); the
# others at about 5x their first readings: mmxlm-soft 4.9e-6, 5.4e-4,
# 5.4e-3; mrc 3.4e-4, 2.4e-4, 1.4e-2; mrm-nce 8.6e-3 (of a loss of 89:
# 1e-4 relative), 4.9e-3, 8.0e-3; itm-ot 2.8e-4, 3.8e-3, 1.4e-2 and
# with ot_pos_only 1.1e-4, 3.3e-3, 2.0e-2 (the OT term's cost matrix is
# taken from the bf16 hidden states of each path); tlm-ni 2.8e-4,
# 4.5e-4, 1.4e-2
OBJ_LIMITS = {"mmxlm": MIX_LIMITS["vmlm"], "vmlm-soft": MIX_LIMITS["vmlm"],
              "mmxlm-soft": (1e-4, 2.7e-3, 2.0 ** -4),
              "mrc": (1.7e-3, 1.2e-3, 2.0 ** -4),
              "mrm-nce": (4.3e-2, 2.5e-2, 2.0 ** -4),
              "itm-ot": (1.4e-3, 1.9e-2, 2.0 ** -3),
              "itm-ot-pos": (1.4e-3, 1.9e-2, 2.0 ** -3),
              "tlm-ni": (1.4e-3, 2.3e-3, 2.0 ** -4)}
OBJ_DIR = os.path.join("build", "objectives_smoke")
OBJ_IMGS, OBJ_STEPS, OBJ_SAVE = 128, 12, 6
# the driver's second run: every task the demo mix leaves out
OBJ_DRIVER_EN = ["mmxlm", "vmlm-soft", "mmxlm-soft", "mrc-kl", "mrm-nce"]
OBJ_DRIVER_DE = ["itm-ot", "tlm-ni"]
IPOT_SHAPE = (128, 62, 100)


def objective_dataset(name, txt_db, img_db, vocab, pc):
    """The dataset ``python -m uc2_torch.pretrain`` builds for ``name``'s
    task (mask probabilities at the driver's defaults)."""
    task = OBJ[name][0]
    if name == "itm-hard":
        return datasets.ItmHardNegDataset(txt_db, img_db, pc["itm_neg_prob"])
    if task == "itm-ot":
        return datasets.ItmDataset(txt_db, img_db, pc["itm_neg_prob"])
    return {
        "mmxlm": lambda: datasets.MmxlmDataset(txt_db, img_db,
                                               label_vocab=vocab, lang="de"),
        "vmlm-soft": lambda: datasets.VmlmSoftDataset(txt_db, img_db,
                                                      label_vocab=vocab),
        "mmxlm-soft": lambda: datasets.MmxlmSoftDataset(txt_db, img_db,
                                                        label_vocab=vocab),
        "mrfr": lambda: datasets.MrfrDataset(txt_db, img_db),
        "mrc": lambda: datasets.MrcDataset(txt_db, img_db),
        "mrc-kl": lambda: datasets.MrcDataset(txt_db, img_db),
        "mrm-nce": lambda: datasets.MrmNceDataset(txt_db, img_db),
        "tlm-ni": lambda: datasets.TlmDataset(
            txt_db, img_db, comasking_mode=pc["comasking_mode"],
            text_only=True),
    }[task]()


def objective_batches(ds, n, rng):
    """``n`` batches of (62 text tokens, 100 regions, B = 128) and the
    dataset's slots, on the card."""
    if hasattr(ds, "new_epoch"):
        ds.new_epoch(rng)
    spec = BucketSpec(TRAIN_TXT, MIX_NB, MIX_B,
                      type(ds).slot_budget(TRAIN_TXT, MIX_NB))
    idx = rng.permutation(len(ds))[:n * MIX_B]
    return [on_card(b) for b in datasets.batches(ds, spec, idx, rng)]


def step_at_dropout_0(what, task, models, start, batch, kw, limits,
                      layers):
    """One step of ``task`` at dropout 0 from the weights ``start`` through
    each of ``models`` ("kernel": "pallas-train" with UC2_FFN_TRAIN=1,
    "eager": "xla", optionally "eager fp32"): the kernel path against the
    eager path in |loss difference|, grad norm (relative) and the worst
    layer's W1 and W2 gradients (fed by #10) in relative norm, held to
    ``limits``; the fp32 step, where given, printed as the anchor of
    both."""
    out = {}
    for path, m_ in models.items():
        m_.load_state_dict(start)
        opt = build_optimizer(m_, constant(4e-5), weight_decay=0.01,
                              betas=(0.9, 0.98), grad_norm=5.0)
        reset_launches()
        met = train_step(m_, opt, batch, DropoutRng(0, "cuda"), task=task,
                         **kw)
        out[path] = (met["loss"].item(), met["grad_norm"].item(),
                     [(a.clone(), b.clone()) for a, b in ffn_grads(m_)],
                     fused_ffn_block_train_bwd.launches)
        del opt

    def apart(a, b):
        """|loss diff|, relative grad norm diff, worst W1 / W2 layer."""
        w = [max(((x[j] - y[j]).norm() / y[j].norm()).item()
                 for x, y in zip(a[2], b[2])) for j in range(2)]
        return abs(a[0] - b[0]), abs(a[1] - b[1]) / b[1], w[0], w[1]

    kern, eager = out["kernel"], out["eager"]
    d = apart(kern, eager)
    loss_tol, norm_rtol, w_rtol = limits
    ok = (d[0] <= loss_tol and d[1] <= norm_rtol and max(d[2:]) <= w_rtol
          and (kern[3], eager[3]) == (layers, 0)
          and np.isfinite(kern[:2]).all())
    print(f"  {what}, one step at dropout 0, kernel path (pallas-train, "
          f"#9/#10 launched {kern[3]} times) vs eager (xla): loss "
          f"{kern[0]:.6f} vs {eager[0]:.6f} (|diff| {d[0]:.3e}), grad "
          f"norm {kern[1]:.6f} vs {eager[1]:.6f} (relative {d[1]:.3e}), "
          f"worst layer's ||dW - dW_eager|| / ||dW_eager|| of W1 / W2 "
          f"{d[2]:.3e} / {d[3]:.3e} (tolerance: loss {loss_tol:g}, grad "
          f"norm {norm_rtol:g} relative, W1/W2 {w_rtol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if "eager fp32" in out:
        f32 = out["eager fp32"]
        for name, run in (("kernel", kern), ("eager bf16", eager)):
            a = apart(run, f32)
            print(f"    {name} vs eager fp32 (loss {f32[0]:.6f}, grad norm "
                  f"{f32[1]:.6f}): loss {a[0]:.3e}, grad norm {a[1]:.3e} "
                  f"relative, W1 / W2 {a[2]:.3e} / {a[3]:.3e}")
    if not ok:
        fail(f"the {what} kernel step disagrees with the eager step")


def repeat_step(task, model, start, batch, kw):
    """One step of ``task`` twice from the same weights and seeds: the
    loss, the grad norm and every updated parameter bit for bit."""
    res = []
    for _ in range(2):
        model.load_state_dict(start)
        m = train_step(model, pretrain_optimizer(model), batch,
                       DropoutRng(7, "cuda"), task=task, **kw)
        res.append((m["loss"], m["grad_norm"],
                    [p.detach().clone() for p in model.parameters()]))
    (l0, n0, p0), (l1, n1, p1) = res
    same = (torch.equal(l0, l1) and torch.equal(n0, n1)
            and all(torch.equal(a, b) for a, b in zip(p0, p1)))
    print(f"  repeat of one {task} step (same weights and seeds): loss "
          f"{l0.item():.6f} / {l1.item():.6f}, grad norm {n0.item():.6f} / "
          f"{n1.item():.6f}, {len(p0)} updated parameters; bitwise equal: "
          f"{same}")
    if not same:
        fail(f"one {task} step with the same seeds is not bitwise "
             f"repeatable")


def time_ipot(card):
    """optimal_transport_dist alone at the itm-ot step's shape (bf16
    blocks, padded rows): ms on the host's clock (synchronised calls), ms
    replayed from a CUDA graph, and the kernels one call launches (a
    profiler count). Returns (host ms, graph ms, kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from uc2_torch.models.ot import optimal_transport_dist
    gen = torch.Generator(device="cuda").manual_seed(5)
    Bo, M, Nr = IPOT_SHAPE
    txt = torch.randn(Bo, M, H, generator=gen, device="cuda").bfloat16()
    img = torch.randn(Bo, Nr, H, generator=gen, device="cuda").bfloat16()
    tpad = torch.arange(M, device="cuda")[None] >= torch.randint(
        10, M + 1, (Bo, 1), generator=gen, device="cuda")
    ipad = torch.arange(Nr, device="cuda")[None] >= torch.randint(
        10, Nr + 1, (Bo, 1), generator=gen, device="cuda")

    def fn():
        return optimal_transport_dist(txt, img, tpad, ipad)
    d = fn()
    if not bool(torch.isfinite(d).all()):
        fail("objectives: IPOT gave non-finite distances")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e2
    graph = graph_ms(fn, iters=5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    kernels = sum(cnt for _, cnt, _ in rows) if rows else None
    print(f"  IPOT alone (optimal_transport_dist, (B, M, N) = {IPOT_SHAPE}, "
          f"D = {H}, 50 iterations): {host:.3f} ms a call on the host's "
          f"clock, {graph:.3f} ms from a CUDA graph, "
          f"{'not measured' if kernels is None else kernels} kernels a call "
          f"(profiler) [{card}]")
    return host, graph, kernels


def objective_specs(stores, which):
    """(train specs, validation specs, flags) of a driver run over the
    stores (en with a soft-label store, de paired): "demo" is
    config/demo_pretrain.json's mix with its stores replaced (itm, mlm,
    mrfr, mrc on en, tlm on de); "others" every other task (the en store
    with its soft labels; itm-ot and tlm-ni on de) with --itm_ot_lambda
    0.1, --optim adamax and --itm_hard_neg."""
    en, de = stores
    if which == "demo":
        with open("config/demo_pretrain.json") as f:
            demo = json.load(f)
        paths = {"demo_en": en, "demo_pair": de, "demo_val": en}
        train, val = ([dict(s, db=[paths[s["name"]]["txt_db"]],
                            img=[paths[s["name"]]["img_db"]])
                       for s in demo[k]]
                      for k in ("train_datasets", "val_datasets"))
        return train, val, []
    train = [{"name": "obj_en", "language": "en", "db": [en["txt_db"]],
              "img": [en["img_db"]],
              "img_token_soft_label": [en["soft_label_db"]],
              "tasks": OBJ_DRIVER_EN, "mix_ratio": [1] * len(OBJ_DRIVER_EN)},
             {"name": "obj_de", "language": "de", "db": [de["txt_db"]],
              "img": [de["img_db"]], "tasks": OBJ_DRIVER_DE,
              "mix_ratio": [1] * len(OBJ_DRIVER_DE)}]
    return (train, [dict(s, name="val_" + s["name"]) for s in train],
            ["--itm_ot_lambda", "0.1", "--optim", "adamax",
             "--itm_hard_neg"])


def objective_argv(out, stores, which, *extra):
    """The driver's command line for ``objective_specs``' run: 12 steps, a
    restore.ckpt every 6, validation (2 batches a task) at 12, on
    config/demo_pretrain.json's settings."""
    train, val, flags = objective_specs(stores, which)
    return ["--config", "config/demo_pretrain.json",
            "--train_datasets", json.dumps(train),
            "--val_datasets", json.dumps(val), "--output_dir", out,
            "--num_train_steps", str(OBJ_STEPS),
            "--save_steps", str(OBJ_SAVE), "--valid_steps", str(OBJ_STEPS),
            "--val_batches", "2", "--log_steps", "1", *flags,
            *PRETRAIN_EXTRA, *extra]


def objective_driver(which, stores, card):
    """One driver run of ``which`` uninterrupted and one stopped at step 6
    and resumed: launches per micro-batch, every task's validation keys,
    bitwise resume. Returns the runs' launches."""
    whole = os.path.join(OBJ_DIR, f"{which}_whole")
    calls = []
    total = no_launches()

    def add(counts):
        for k, n in counts.items():
            total[k] += n
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with counted_eval_steps(calls):
        run = run_pretrain(objective_argv(whole, stores, which))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    layers = run.model.config.num_hidden_layers
    want = OBJ_STEPS * layers
    tasks = sorted({t for _, t, _ in run.losses})
    rows = loop_times(run, {OBJ_SAVE, OBJ_STEPS})
    ms = sorted(r[0] for r in rows)
    print(f"  driver ({which}): {run.step} steps of {tasks} in {dt:.1f} s, "
          f"{np.median(ms):.1f} ms/step median ({ms[0]:.1f}-{ms[-1]:.1f}) "
          f"over the {len(rows)} steps that hold no save or validation "
          f"[{card}]")
    print(f"    losses {[(s, t, round(v, 4)) for s, t, v in run.losses]}")
    print(f"    validation: {run.val}; {len(calls)} eval batches, "
          f"{sum(ok for _, _, ok in calls)} with the gates' launches")
    for k in TRAIN_KERNELS:
        if counts[k.__name__] != want:
            fail(f"objectives driver ({which}): {k.__name__} launched "
                 f"{counts[k.__name__]} times, want {want} (12 a "
                 f"micro-batch)")
    for k in FFN_KERNELS + ROUTE_KERNELS + LAB_KERNELS:
        if counts[k.__name__]:
            fail(f"objectives driver ({which}): {k.__name__} launched off "
                 f"the path")
    _, val, _ = objective_specs(stores, which)
    logged = {k.split("_")[0]: v for k, v in run.val.items()}
    for task in {t for spec in val for t in spec["tasks"]}:
        need = {"loss"} | ({"l2", "cos", "acc"} if task == "mrm-nce" else
                           {"ot_pos", "ot_neg", "acc"} if task == "itm-ot"
                           else set() if task == "mrfr" else {"acc"})
        log = logged.get(task, {})
        if not need <= set(log) or not np.isfinite(list(log.values())).all():
            fail(f"objectives driver ({which}): validation of {task} logged "
                 f"{log}, want the keys {sorted(need)}")
    if len(run.val) != sum(len(spec["tasks"]) for spec in val) or not calls:
        fail(f"objectives driver ({which}): validation logged "
             f"{sorted(run.val)}")
    bad = [(s, t, v) for s, t, v in run.losses if not np.isfinite(v)]
    if bad or len(run.losses) != OBJ_STEPS:
        fail(f"objectives driver ({which}): non-finite or missing losses "
             f"{bad}")
    want_state, want_losses = trained_state(run), run.losses
    del run
    shutil.rmtree(whole, ignore_errors=True)
    torch.cuda.empty_cache()

    resumed = os.path.join(OBJ_DIR, f"{which}_resumed")
    reset_launches()
    first = run_pretrain(objective_argv(resumed, stores, which,
                                        "--stop_after_steps", str(OBJ_SAVE)))
    first_losses = first.losses
    del first
    second = run_pretrain(objective_argv(resumed, stores, which))
    torch.cuda.synchronize()
    counts = launch_counts()
    add(counts)
    got = trained_state(second)
    losses = first_losses + second.losses
    diff = {k: (got[k].float() - want_state[k].float()).abs().max().item()
            for k in want_state if not torch.equal(got[k], want_state[k])}
    if diff or losses != want_losses or set(got) != set(want_state):
        worst = max(diff.items(), key=lambda kv: kv[1]) if diff else None
        fail(f"objectives driver ({which}): the resumed run is not the "
             f"uninterrupted one bit for bit: {len(diff)} tensors differ "
             f"(largest {worst}), losses equal: {losses == want_losses}")
    else:
        print(f"    the run stopped at step {OBJ_SAVE} and resumed equals "
              f"the uninterrupted one bit for bit: {len(want_state)} "
              f"parameter and moment tensors, {len(losses)} step losses")
    for k in TRAIN_KERNELS:
        if counts[k.__name__] != want:
            fail(f"objectives driver ({which}): the resumed runs launched "
                 f"{k.__name__} {counts[k.__name__]} times, want {want}")
    del second
    shutil.rmtree(resumed, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


def phase_objectives(card):
    """The objectives beyond the mix: each at full width from an in-memory
    corpus, IPOT alone, and the pretraining driver on the demo mix and on
    every other task. Returns the launches of its runs."""
    print("== objectives: uc2-base steps of mmxlm, vmlm-soft, mmxlm-soft, "
          "mrfr, mrc, mrc-kl, mrm-nce, itm-ot (both reductions), itm on hard "
          "negatives and tlm-ni (co-masked) under pallas-train with "
          "UC2_FFN_TRAIN=1; IPOT; the driver on config/demo_pretrain.json's "
          "mix and on every other task")
    shutil.rmtree(OBJ_DIR, ignore_errors=True)
    try:
        with env_set("UC2_FFN_TRAIN", "1"):
            launches, step_ms = _objective_steps(card)
        host, graph, kernels = time_ipot(card)
        itm_ms, ot_ms = step_ms["itm-hard"], step_ms["itm-ot"]
        print(f"  itm-ot step {ot_ms:.3f} ms against itm's {itm_ms:.3f} ms: "
              f"OT takes {(ot_ms - itm_ms) / ot_ms:.1%} of the itm-ot step "
              f"(IPOT alone {host:.3f} ms on the host's clock, {graph:.3f} "
              f"ms from a graph) [{card}]")
        t0 = time.perf_counter()
        n_valid = len(LabelVocab().valid_ids)   # the driver's vocabulary
        stores = (synth_corpus(os.path.join(OBJ_DIR, "en"), n_imgs=OBJ_IMGS,
                               txt_per_img=2, seed=0,
                               soft_label_dim=n_valid),
                  synth_corpus(os.path.join(OBJ_DIR, "de"), n_imgs=OBJ_IMGS,
                               txt_per_img=2, seed=1, paired=True))
        print(f"  stores: en (unpaired, with a soft-label store of {n_valid} "
              f"token columns) and de (paired), {OBJ_IMGS} images x 2 "
              f"captions each, written in {time.perf_counter() - t0:.1f} s")
        for which in ("demo", "others"):
            for k, n in objective_driver(which, stores, card).items():
                launches[k] += n
        return launches
    finally:
        shutil.rmtree(OBJ_DIR, ignore_errors=True)


def _objective_steps(card):
    """Each task of OBJ: three timed steps after a warm-up (launches,
    finite losses, ms/step, peak memory), a deterministic eval_step (the
    gates' launches), the bitwise repeats, one step against the eager path
    at dropout 0. Returns the launches and each task's median ms/step."""
    with open("config/uc2_pretrain.json") as f:
        pc = json.load(f)
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention="pallas-train")
    cfg0 = cfg.replace(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    t0 = time.perf_counter()
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    models = {path: UC2ForPretraining(cfg0.replace(
        use_pallas_attention=impl), device="cuda", seed=0)
        for path, impl in (("kernel", "pallas-train"), ("eager", "xla"))}
    txt_db, img_db = synth_pretrain_corpus(3, n_imgs=N_IMGS, txt_per_img=2,
                                           vocab=cfg.vocab_size,
                                           img_dim=cfg.img_dim)
    vocab = LabelVocab(tokenize=hash_tokenize)
    print(f"  models and corpus ({len(txt_db.ids)} paired captions of "
          f"{N_IMGS} images; label vocabulary: hash ids, "
          f"{len(vocab.valid_ids)} valid tokens) ready in "
          f"{time.perf_counter() - t0:.1f} s")
    layers = cfg.num_hidden_layers
    per_step = no_launches()
    per_step.update({k.__name__: layers for k in TRAIN_KERNELS + FFN_KERNELS})
    total = no_launches()
    step_ms = {}
    rng = np.random.default_rng(3)
    for name, (task, kw) in OBJ.items():
        kw = dict(kw, valid_ids=vocab.valid_ids)
        t0 = time.perf_counter()
        batches = objective_batches(objective_dataset(
            name, txt_db, img_db, vocab, pc), 1 + MIX_STEPS, rng)
        t_data = time.perf_counter() - t0
        model.load_state_dict(start)
        opt = pretrain_optimizer(model)
        drop = DropoutRng(TRAIN_SEED, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, mets = [], []
        for i, batch in enumerate(batches):
            if i == 1:
                torch.cuda.synchronize()
                reset_launches()
            t1 = time.perf_counter()
            mets.append(train_step(model, opt, batch, drop, task=task, **kw))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launch_counts()
        for k, n in counts.items():
            total[k] += n
        want = {k: v * MIX_STEPS for k, v in per_step.items()}
        ms = float(np.median(times[1:]))
        step_ms[name] = ms
        b0 = batches[0]
        L = b0["attn_mask"].shape[1]
        M = b0["masked_pos"].shape[1] if "masked_pos" in b0 else 0
        extra = {k: round(v.item(), 4) for k, v in mets[-1].items()
                 if k not in ("loss", "n_units", "grad_norm")}
        print(f"  {name} ({task}) L={L} B={MIX_B} M={M}: {ms:.3f} ms/step "
              f"median = {MIX_B / ms * 1e3:.1f} examples/s (steps "
              f"{', '.join(f'{t:.2f}' for t in times[1:])}; warm-up "
              f"{times[0]:.1f} ms), peak memory {peak:.2f} GiB; batches "
              f"built in {t_data:.1f} s [{card}]")
        print(f"    loss / grad norm: " + "; ".join(
            f"{m['loss'].item():.4f} / {m['grad_norm'].item():.4f}"
            for m in mets) + (f"; last step's metrics {extra}" if extra
                              else ""))
        if counts != want:
            fail(f"objectives: {name} launched {counts} over its timed "
                 f"steps; want 12 each of #5, #6a, #6b, #9, #10 a step")
        if not all(np.isfinite([m["loss"].item(), m["grad_norm"].item()])
                   .all() for m in mets):
            fail(f"objectives: {name}: a loss or grad norm is not finite")
        # the deterministic validation forward, through the gates' kernels
        torch.cuda.synchronize()
        reset_launches()
        ev = train_step_mod.eval_step(model, b0, task,
                                      valid_ids=vocab.valid_ids)
        torch.cuda.synchronize()
        got = {k: n for k, n in launch_counts().items() if n}
        for k, n in got.items():
            total[k] += n
        gate = {k: n for k, n in gate_launches(cfg, L).items() if n}
        sums = {k: round(v.item(), 4) for k, v in ev.items()}
        print(f"    eval_step: {sums}; launches {got} (the gates at L={L}: "
              f"{gate})")
        if got != gate or not all(np.isfinite(v.item()) for v in ev.values()):
            fail(f"objectives: eval_step of {name} launched {got} (the gates "
                 f"want {gate}) or is not finite")
        if name in OBJ_REPEAT:
            repeat_step(task, model, start, b0, kw)
        step_at_dropout_0(name, task, models, start, b0, kw,
                          OBJ_LIMITS.get(name, MIX_LIMITS["itm"]), layers)
        del batches, opt
        torch.cuda.empty_cache()
    del model, models
    torch.cuda.empty_cache()
    return total, step_ms


# ------------------------------------------------ the retrieval finetuning
ITM_CONFIG = "config/uc2_mscoco_itm.json"
ITM_DIR = os.path.join("build", "itm_smoke")
# images of each split's store, captions an image in the training stores,
# texts of the validation and test stores
ITM_IMGS, ITM_EVAL_TXTS = 64, 32
ITM_STEPS, ITM_STOP = 6, 3
ITM_HARD_STEPS = 5       # mined before step 1 and after step 3
ITM_EVAL_BATCH = 300     # the config's inference batch
ITM_HARD_EVAL_BATCH = 64


def text_store(out, *parts):
    """One text store of the records of several (texts' store, id prefix)
    parts, with its sidecar files: the COCO-CN case, whose texts name
    images of both train2014 and val2014."""
    from uc2_torch.data.store import StoreReader, StoreWriter
    os.makedirs(out, exist_ok=True)
    id2len, txt2img, img2txts, meta = {}, {}, {}, None
    with StoreWriter(os.path.join(out, "txt.u2s")) as w:
        for src, tag in parts:
            reader = StoreReader(os.path.join(src, "txt.u2s"))
            with open(os.path.join(src, "txt2img.json")) as f:
                names = json.load(f)
            with open(os.path.join(src, "meta.json")) as f:
                meta = json.load(f)
            for tid, img in names.items():
                rec = reader[tid]
                w.put(f"{tag}{tid}", rec)
                id2len[f"{tag}{tid}"] = len(rec["input_ids"])
                txt2img[f"{tag}{tid}"] = img
                img2txts.setdefault(img, []).append(f"{tag}{tid}")
    for name, obj in (("id2len", id2len), ("txt2img", txt2img),
                      ("img2txts", img2txts), ("meta", meta)):
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    return out


def itm_stores():
    """The config's databases at the reference's widths, under ITM_DIR:
    train2014 and val2014 image stores (ITM_IMGS images each, 2048-d fp16
    features, 10-100 boxes), the four training text stores (en train and
    ja on train2014, en restval on val2014, zh on both), the en
    validation and test texts (val2014) and a zh test (both), vocab
    250002. Stores of texts alone carry a 1-d image store of their own,
    which no run reads."""
    def corpus(name, prefix, seed, n_imgs=ITM_IMGS, txt_per_img=1, **kw):
        return synth_corpus(os.path.join(ITM_DIR, name), n_imgs=n_imgs,
                            txt_per_img=txt_per_img, seed=seed,
                            fname_prefix=f"coco_{prefix}", **kw)
    texts = dict(img_dim=1, n_classes=2)
    train, val = corpus("train2014", "train2014", 0), corpus(
        "val2014", "val2014", 1)
    half = ITM_EVAL_TXTS // 2
    zh = [corpus(f"zh_{p}", p, 2 + i, n_imgs=ITM_IMGS // 2, **texts)
          for i, p in enumerate(("train2014", "val2014"))]
    zh_test = [corpus(f"zh_test_{p}", p, 4 + i, n_imgs=half, **texts)
               for i, p in enumerate(("train2014", "val2014"))]
    return {"train2014": train["img_db"], "val2014": val["img_db"],
            "en_train": train["txt_db"], "en_restval": val["txt_db"],
            "ja_train": corpus("ja", "train2014", 6, **texts)["txt_db"],
            "zh_train": text_store(os.path.join(ITM_DIR, "zh_txt"),
                                   *((c["txt_db"], f"zh{i}_")
                                     for i, c in enumerate(zh))),
            "en_val": corpus("en_val", "val2014", 7, n_imgs=ITM_EVAL_TXTS,
                             **texts)["txt_db"],
            "en_test": corpus("en_test", "val2014", 8,
                              n_imgs=ITM_EVAL_TXTS, **texts)["txt_db"],
            "zh_test": text_store(os.path.join(ITM_DIR, "zh_test_txt"),
                                  *((c["txt_db"], f"zh{i}_")
                                    for i, c in enumerate(zh_test)))}


def itm_argv(out, stores, ckpt, *extra):
    """config/uc2_mscoco_itm.json with its stores replaced (the four
    training pairs in its order, zh on the [train2014, val2014] routing
    pair; validation on en val; two test pairs, en on val2014 and zh on
    the routing pair), the checkpoint and output directory, and a short
    run: 6 steps with validation and a restore.ckpt every 3, warm-up 2
    steps, a log line every step."""
    s = stores
    route = [s["train2014"], s["val2014"]]
    return ["--config", ITM_CONFIG,
            "--train_txt_db", json.dumps([s["en_train"], s["en_restval"],
                                          s["ja_train"], s["zh_train"]]),
            "--train_img_db", json.dumps([s["train2014"], s["val2014"],
                                          s["train2014"], route]),
            "--val_txt_db", s["en_val"], "--val_img_db", s["val2014"],
            "--test_datasets", json.dumps([
                {"name": "coco_en_test", "db": s["en_test"],
                 "img": s["val2014"]},
                {"name": "coco_zh_test", "db": s["zh_test"], "img": route}]),
            "--checkpoint", ckpt, "--output_dir", out,
            "--num_train_steps", str(ITM_STEPS), "--valid_steps",
            str(ITM_STOP), "--save_steps", str(ITM_STOP),
            "--warmup_steps", "2", "--log_steps", "1", *extra]


def run_itm(argv):
    """``uc2_torch.itm.main`` as ``python -m uc2_torch.itm argv`` runs it,
    in this process."""
    parser = itm.build_parser()
    opts = itm.parse_with_config(parser, argv)
    itm.apply_reference_config_compat(opts, parser, argv)
    return itm.main(opts)


@contextlib.contextmanager
def recorded_scores(calls, evals=None, outputs=None):
    """Record (deterministic, quant, joint L) of every ``scores`` call of
    the retrieval model: the training forwards and the scored batches;
    with ``evals``, also (quant, seconds, scored batches) of every
    ``full_retrieval_eval`` (synchronised before and after); with
    ``outputs``, the scores of every deterministic call."""
    orig, orig_eval = (UC2ForImageTextRetrieval.scores,
                       retrieval.full_retrieval_eval)

    def scores(self, batch, deterministic=True, rng=None):
        calls.append((deterministic, self.config.quant,
                      batch["attn_mask"].shape[1]))
        out = orig(self, batch, deterministic, rng)
        if outputs is not None and deterministic:
            outputs.append(out.detach())
        return out

    def full_eval(model, *a, **k):
        torch.cuda.synchronize()
        n0, t0 = len(calls), time.perf_counter()
        out = orig_eval(model, *a, **k)
        torch.cuda.synchronize()
        evals.append((model.config.quant, time.perf_counter() - t0,
                      len(calls) - n0))
        return out
    UC2ForImageTextRetrieval.scores = scores
    if evals is not None:
        retrieval.full_retrieval_eval = full_eval
    try:
        yield
    finally:
        UC2ForImageTextRetrieval.scores = orig
        retrieval.full_retrieval_eval = orig_eval


@contextlib.contextmanager
def timed_loader(times):
    """Record the host's seconds of every ``TaskLoader.next_stacked`` (the
    driver's batch assembly: reads, groups, collate)."""
    orig = TaskLoader.next_stacked

    def next_stacked(self, n):
        t0 = time.perf_counter()
        out = orig(self, n)
        times.append(time.perf_counter() - t0)
        return out
    TaskLoader.next_stacked = next_stacked
    try:
        yield
    finally:
        TaskLoader.next_stacked = orig


def itm_launches(what, cfg, calls, steps, accum, counts):
    """The run's launches against the routing: 12 each of #5, #6a, #6b a
    micro-batch of every step, and for each scored batch the gates'
    kernels at its joint length; nothing else."""
    layers = cfg.num_hidden_layers
    train = [L for det, _, L in calls if not det]
    want = no_launches()
    for k in TRAIN_KERNELS:
        want[k.__name__] = steps * accum * layers
    for det, _, L in calls:
        if det:
            for k, n in gate_launches(cfg, L).items():
                want[k] += n
    scored = sorted({L for det, _, L in calls if det})
    print(f"  {what}: {len(train)} training forwards at L {sorted(set(train))}"
          f" ({steps} steps x {accum} micro-batches), "
          f"{len(calls) - len(train)} scored batches at L {scored}; launches "
          f"{ {k: n for k, n in counts.items() if n} }")
    if len(train) != steps * accum or counts != want:
        fail(f"itm {what}: launched {counts}, the routing wants "
             f"{ {k: n for k, n in want.items() if n} } "
             f"({len(train)} training forwards)")


def itm_state(model, opt):
    """The parameters, AdamW's moments and its count, copied to the host
    (outside the runs' peak memory)."""
    out = {f"param {k}": v.detach().cpu()
           for k, v in model.state_dict().items()}
    for i, st in opt.state_dict()["state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{k} {i}"] = st[k].detach().cpu()
    out["count"] = torch.tensor(opt.count)
    return out


def itm_run_report(what, run, card, skip):
    """ms/step of the loop (the intervals that hold no validation, mining
    or save), the losses, validations, minings and tests of a run."""
    rows = loop_times(run, skip)
    ms = sorted(r[0] for r in rows)
    print(f"  {what}: steps {[s for s, _ in run.losses]}, rank losses "
          f"{[round(v, 5) for _, v in run.losses]}; "
          + (f"{np.median(ms):.1f} ms/step median ({ms[0]:.1f}-{ms[-1]:.1f})"
             f" over {len(ms)} steps, per step {[round(m, 1) for m in ms]}"
             if ms else "no timed step") + f" [{card}]")
    for step, log in run.val:
        print(f"    validation at step {step}: "
              f"{ {k: round(v, 4) for k, v in log.items()} }")
    for step, sec, files in run.mined:
        print(f"    mining at step {step}: {sec:.2f} s, "
              f"{[os.path.basename(f) for f in files]}")
    for name, log in run.results.items():
        print(f"    test {name}: {json.dumps({k: round(v, 4) for k, v in log.items()})}")
    bad = [(s, v) for s, v in run.losses if not np.isfinite(v)]
    bad += [(s, k, v) for s, log in run.val for k, v in log.items()
            if not np.isfinite(v)]
    if bad:
        fail(f"itm {what}: non-finite losses or validation {bad}")
    return ms


def rank_batch(stores, S, n_groups, accum, seed):
    """One stacked batch of ``accum`` micro-batches of ``n_groups`` rank
    groups (``S`` rows each) from the en train pair, on the card."""
    txt = db.TxtTokDb(stores["en_train"])
    img = db.DetectFeatDb(stores["train2014"])
    ds = datasets.ItmRankDataset(txt, img, (S - 1) // 2)
    tl = TaskLoader("itm-rank", ds, [BucketSpec(TXT_LEN, NUM_BB, n_groups,
                                                0)], seed=seed)
    batch = tl.next_stacked(accum)
    for k in ("_bucket", "sample_size", "targets"):
        batch.pop(k)
    return {k: torch.from_numpy(v).to("cuda").float()
            if v.dtype == np.float16 else torch.from_numpy(v).to("cuda")
            for k, v in batch.items()}


# one rank step at dropout 0 from the port's initialised weights, the
# kernel path ("pallas-train": #5 and #6's passes at rate 0) and the eager
# bf16 path ("xla") each against the eager fp32 path: at init the rank
# loss's gradients are small (grad norm ~0.1), and the Q/K/V gradients of
# either bf16 path are 11% (relative norm) from fp32's, 5% of the updates
# more than lr / 10 from fp32's (H100 readings), beyond the mlm step's
# limits; so the kernel path's gradients are held to the eager bf16
# path's own distance from fp32 (within RANK_VS_EAGER times it, plus
# RANK_FLOOR), and its loss to the mlm step's STEP_LOSS_TOL from fp32's.
# The H100 readings put the kernel path at 0.95-1.0 times the eager
# path's distance on each measure; the factor 2 leaves room for a kernel
# that rounds in another order. The step is the end-to-end guard: a fault
# of #5 or #6 at these shapes is caught by ``itm_train_kernels`` at the
# kernels' own tolerances
RANK_VS_EAGER, RANK_FLOOR = 2.0, 1e-4


def paths_vs_fp32(make, cfg, start, batch, lr, task, **kw):
    """One dropout-0 step of ``task`` from ``start`` on each path, the
    model built by ``make(config)``; returns {path: (loss, grad norm,
    update, [per layer Q/K/V gradients], launches)}."""
    cfg0 = set_dropout(cfg, 0.0)
    out = {}
    for path, impl, dt in (("kernel", "pallas-train", cfg.dtype),
                           ("eager", "xla", cfg.dtype),
                           ("fp32", "xla", "float32")):
        m_ = make(cfg0.replace(use_pallas_attention=impl, dtype=dt))
        m_.load_state_dict(start)
        opt = build_optimizer(m_, constant(lr), weight_decay=0.0,
                              betas=(0.9, 0.98), grad_norm=2.0)
        reset_launches()
        met = train_step(m_, opt, batch, DropoutRng(0, "cuda"), task=task,
                         **kw)
        out[path] = (met["loss"].item(), met["grad_norm"].item(),
                     torch.cat([(p.detach() - start[n]).flatten()
                                for n, p in m_.named_parameters()]),
                     [lay.attention.qkv.weight.grad.split(H)
                      for lay in m_.roberta.layer], launch_counts())
        del m_, opt
        torch.cuda.empty_cache()
    return out


def profile_task_step(what, model, opt, batch, task, **kw):
    """One step under torch.profiler: its wall time, the device's busy
    and idle share and device ms by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, batch, DropoutRng(7, "cuda"), task=task, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(device_rows(prof), reverse=True)
    if not rows:
        print(f"  {what} step profile: no device time recorded (not "
              f"measured)")
        return
    busy = sum(r[0] for r in rows)
    print(f"  profiled {what} step: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall:.1%}; idle {1 - busy / wall:.1%}), "
          f"{sum(r[1] for r in rows)} device activities; by group: "
          + ", ".join(f"{g} {ms:.1f} ms" for g, ms in sorted(
              group_ms(rows, KERNEL_GROUPS).items(), key=lambda x: -x[1])))
    for ms, cnt, key in rows[:8]:
        print(f"    {ms:9.3f} ms {cnt:5d}x  {key[:100]}")


def step_checks(what, make, cfg, start, batch, task, loss_rtol=None, **kw):
    """One ``task`` step twice from the same weights and seeds (bit for
    bit), its time alone and profiled, and one step at dropout 0 through
    the kernel path against the eager fp32 path, beside the eager bf16
    path's distance (RANK_VS_EAGER, RANK_FLOOR), with a clip of 2.0, its
    loss within STEP_LOSS_TOL of the fp32 path's (or ``loss_rtol`` of
    it); the model built by ``make(config)``, the batch plain or stacked.
    Returns the step's ms alone."""
    model = make(cfg)
    accum = batch["input_ids"].shape[0] if batch["input_ids"].dim() == 3 \
        else 1
    res = []
    for _ in range(2):
        model.load_state_dict(start)
        opt = build_optimizer(model, constant(1e-4), weight_decay=0.0,
                              betas=(0.9, 0.98), grad_norm=2.0)
        m = train_step(model, opt, batch, DropoutRng(7, "cuda"), task=task,
                       **kw)
        res.append((m["loss"], m["grad_norm"],
                    [p.detach().clone() for p in model.parameters()]))
    (l0, n0, p0), (l1, n1, p1) = res
    same = (torch.equal(l0, l1) and torch.equal(n0, n1)
            and all(torch.equal(a, b) for a, b in zip(p0, p1)))
    print(f"  repeat of one {what} step ({accum} micro-batch"
          f"{'es' if accum > 1 else ''}, same weights and seeds): loss "
          f"{l0.item():.6f} / {l1.item():.6f}, grad norm {n0.item():.6f} / "
          f"{n1.item():.6f}, {len(p0)} updated parameters; bitwise equal: "
          f"{same}")
    if not same:
        fail(f"one {what} step with the same seeds is not bitwise "
             f"repeatable")
    del res, p0, p1
    times = []
    for _ in range(1 + 3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        train_step(model, opt, batch, DropoutRng(7, "cuda"), task=task, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    alone = float(np.median(times[1:]))
    print(f"  the {what} step alone (one batch on the card, no data "
          f"work): {alone:.1f} ms median of 3 after a warm-up "
          f"({', '.join(f'{t:.1f}' for t in times[1:])})")
    profile_task_step(what, model, opt, batch, task, **kw)
    del model, opt
    torch.cuda.empty_cache()

    lr, layers = 1e-4, cfg.num_hidden_layers
    out = paths_vs_fp32(make, cfg, start, batch, lr, task, **kw)

    def apart(a, b):
        """|loss diff|, relative grad norm diff, worst layer's Q / K / V
        gradient in relative norm, share of updates > lr / 10 apart."""
        qkv = max(((x[j] - y[j]).norm() / y[j].norm()).item()
                  for x, y in zip(a[3], b[3]) for j in range(3))
        flips = ((a[2] - b[2]).abs() > lr / 10).float().mean().item()
        return (abs(a[0] - b[0]), abs(a[1] - b[1]) / b[1], qkv, flips)
    kern, eager = apart(out["kernel"], out["fp32"]), apart(out["eager"],
                                                           out["fp32"])
    launched = [out["kernel"][4][k.__name__] for k in TRAIN_KERNELS]
    loss_tol = (STEP_LOSS_TOL if loss_rtol is None
                else loss_rtol * abs(out["fp32"][0]))
    ok = (launched == [layers * accum] * 3 and kern[0] <= loss_tol
          and all(k <= RANK_VS_EAGER * e + RANK_FLOOR
                  for k, e in zip(kern[1:], eager[1:]))
          and np.isfinite([out["kernel"][0], out["kernel"][1]]).all())
    names = ("|loss - fp32|", "grad norm vs fp32 (relative)",
             "worst Q/K/V gradient vs fp32 (relative norm)",
             "share of updates > lr/10 from fp32's")
    print(f"  one {what} step at dropout 0 (fp32 path: loss "
          f"{out['fp32'][0]:.6f}, grad norm {out['fp32'][1]:.6f}); kernel "
          f"path (pallas-train, #5/#6a/#6b {launched}) vs eager bf16 (xla): "
          + "; ".join(f"{n} {k:.3e} vs {e:.3e}"
                      for n, k, e in zip(names, kern, eager))
          + f" (tolerance: loss {loss_tol:g}; the others kernel <= "
            f"{RANK_VS_EAGER:g} x eager + {RANK_FLOOR:g}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the kernel {what} step is further from fp32 than the eager "
             f"bf16 step allows")
    return alone


def rank_step_checks(cfg, start, batch, S):
    """``step_checks`` of one stacked rank step (the itm config's 8
    micro-batches)."""
    return step_checks(
        "rank", lambda c: UC2ForImageTextRetrieval(c, device="cuda", seed=0),
        cfg, start, batch, "itm-rank", sample_size=S)


def train_kernels_at(rows, gen, shapes):
    """``train_attention_case`` at each (B, L) of ``shapes``, rates 0.1
    and 0: #5 and #6's passes against their plain versions at the shapes
    a driver gives them."""
    for b, L in shapes:
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            train_attention_case(f"B={b} L={L} rate={rate}", q, k, v, bias,
                                 g, rate, rows)
        del q, k, v, bias, g
    torch.cuda.empty_cache()


def itm_train_kernels(rows, gen):
    """#5 and #6 at the itm driver's micro-batches, B = 39 (the recipe's
    13 groups of 3) and 40 (the hard-negative run's 8 groups of 5) at
    L = 162."""
    train_kernels_at(rows, gen, ((39, TXT_LEN + NUM_BB),
                                 (40, TXT_LEN + NUM_BB)))


def itm_kernels_at_300(rows, gen):
    """#1 at (300, 98), #2 at (300, 128) and (300, 162) and #3 at all
    three: the config's inference batch, each against its plain version
    and timed beside its bound (not the JSON row's times)."""
    b = ITM_EVAL_BATCH
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)
    w1 = (torch.randn(FF, H, generator=gen, device="cuda") * 0.05).bfloat16()
    w2 = (torch.randn(H, FF, generator=gen, device="cuda") * 0.05).bfloat16()
    b1, b2 = vec(gen, FF, 0.02), vec(gen, H, 0.02)
    for L in (98, 128, 162):
        q, k, v, bias = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        if L == 98:
            run_case(rows, "flash_attention", b, L, flash_attention_v3,
                     flash_attention_plain, (q, k, v, bias),
                     4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D)
        else:
            run_case(rows, "fused_attn_block", b, L, fused_attn_block,
                     fused_attn_block_plain,
                     (q, k, v, bias, x, wo, bo, gamma, beta),
                     *block_bytes_flops(b, L))
        run_case(rows, "fused_ffn_block", b, L, fused_ffn_block,
                 fused_ffn_block_plain, (x, w1, b1, w2, b2, gamma, beta),
                 2 * b * L * H * 2 + 2 * H * FF * 2 + (FF + 3 * H) * 4,
                 4 * b * L * H * FF)
        del q, k, v, bias, x
    torch.cuda.empty_cache()


def itm_pairs_per_s(model, stores, card):
    """model.scores on one batch of 300 images a region-count bucket (one
    en validation text against them, as score_matrix builds it): ms a
    batch (CUDA events, 10 calls) and pairs/s."""
    txt = db.TxtTokDb(stores["en_val"])
    img = db.DetectFeatDb(stores["val2014"])
    names = sorted(img.name2nbb, key=lambda n: img.name2nbb[n])
    edges = retrieval.bucket_edges(TXT_LEN, NUM_BB)
    out = []
    for lo, nb in zip([0] + edges[:-1], edges):
        sel = [n for n in names if lo < img.name2nbb[n] <= nb]
        if not sel:
            fail(f"itm: no validation image has {lo + 1}-{nb} regions")
            continue
        feats, bb7, nbbs = retrieval.load_image_gallery(img, sel, nb)
        reps = -(-ITM_EVAL_BATCH // len(sel))
        f = torch.from_numpy(np.tile(feats, (reps, 1, 1))[:ITM_EVAL_BATCH])
        b7 = torch.from_numpy(np.tile(bb7, (reps, 1, 1))[:ITM_EVAL_BATCH])
        n = np.tile(nbbs, reps)[:ITM_EVAL_BATCH]
        rmask = torch.from_numpy(np.arange(nb)[None] < n[:, None]).long()
        ids = np.asarray(txt.combine_inputs(txt[txt.ids[0]]["input_ids"]))
        row = torch.ones(TXT_LEN, dtype=torch.long)
        row[:len(ids)] = torch.from_numpy(ids)
        tmask = (row != 1).long()                      # pad id 1
        batch = {k: t.cuda() for k, t in (
            ("input_ids", row.expand(ITM_EVAL_BATCH, TXT_LEN)),
            ("img_feat", f), ("img_pos_feat", b7),
            ("attn_mask", torch.cat([tmask.expand(ITM_EVAL_BATCH, TXT_LEN),
                                     rmask], 1)))}
        ms = time_ms(lambda: model.scores(batch), iters=10)
        out.append((TXT_LEN + nb, ms))
        print(f"  scoring B={ITM_EVAL_BATCH} L={TXT_LEN + nb}: {ms:.3f} ms a "
              f"batch = {ITM_EVAL_BATCH / ms * 1e3:.0f} pairs/s [{card}]")
    return out


def phase_itm(card, rows, gen):
    """``python -m uc2_torch.itm --config config/uc2_mscoco_itm.json`` in
    this process on U2S stores at the reference's widths (uc2-base at full
    width): the shipped recipe stopped at step 3 and resumed to 6, then
    with hard negatives; #5 and #6 at the micro-batches' shapes and the
    inference kernels at the config's batch of 300; a rank step repeated
    and against the eager path. Returns the
    launches of its runs."""
    print(f"== itm: python -m uc2_torch.itm --config {ITM_CONFIG} on U2S "
          f"stores, uc2-base at full width [{card}]")
    shutil.rmtree(ITM_DIR, ignore_errors=True)
    try:
        return _phase_itm(card, rows, gen)
    finally:
        shutil.rmtree(ITM_DIR, ignore_errors=True)


def _phase_itm(card, rows, gen):
    t0 = time.perf_counter()
    stores = itm_stores()
    with open(ITM_CONFIG) as f:
        ic = json.load(f)
    cfg = set_dropout(UC2Config.from_json_file(ic["model_config"]).replace(
        dtype=ic["dtype"]), ic["dropout"])
    ckpt = os.path.join(ITM_DIR, "init.pt")
    init = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    torch.save({k: v.cpu() for k, v in init.state_dict().items()}, ckpt)
    del init
    print(f"  stores (train2014 and val2014 images: {ITM_IMGS} each, 2048-d "
          f"fp16 features, 10-100 boxes; training texts en train, en "
          f"restval, ja, zh (both splits); {ITM_EVAL_TXTS} validation and "
          f"test texts a db) and a checkpoint of the port's initialised "
          f"weights written in {time.perf_counter() - t0:.1f} s")
    print(f"  overrides of {ITM_CONFIG}: --train_txt_db, --train_img_db, "
          f"--val_txt_db, --val_img_db (the stores above), --test_datasets "
          f"(en test on val2014, zh test on the routing pair), --checkpoint "
          f"{ckpt}, --output_dir, --num_train_steps {ITM_STEPS}, "
          f"--valid_steps {ITM_STOP}, --save_steps {ITM_STOP}, "
          f"--warmup_steps 2, --log_steps 1; kept: its four training pairs "
          f"with the zh routing pair, train_batch_size {ic['train_batch_size']}"
          f", negative_size {ic['negative_size']}, accumulation "
          f"{ic['gradient_accumulation_steps']}, dropout {ic['dropout']}, "
          f"eval_batch_size {ic['eval_batch_size']}, bf16")
    accum = ic["gradient_accumulation_steps"]
    total = no_launches()

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    # (a) and (b): the recipe stopped after step 3 and resumed to 6
    out = os.path.join(ITM_DIR, "recipe")
    calls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loads = []
    with recorded_scores(calls), timed_loader(loads):
        first = run_itm(itm_argv(out, stores, ckpt, "--stop_after_steps",
                                 str(ITM_STOP)))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = itm_state(first.model, first.optimizer)
        S = first.sample_size
        ms = itm_run_report("recipe, steps 1-3", first, card, {ITM_STOP})
        del first
        torch.cuda.empty_cache()
        restored = []
        real = itm_checkpoint.TrainingRestorer.restore

        def restore(self, model, opt):
            step = real(self, model, opt)
            restored.append((step, itm_state(model, opt)))
            return step
        itm_checkpoint.TrainingRestorer.restore = restore
        try:
            second = run_itm(itm_argv(out, stores, ckpt))
        finally:
            itm_checkpoint.TrainingRestorer.restore = real
    torch.cuda.synchronize()
    counts = launch_counts()
    add(counts)
    ms += itm_run_report("recipe, resumed, steps 4-6", second, card,
                         {ITM_STEPS})
    ms.sort()
    groups = ic["train_batch_size"] // S
    print(f"  recipe: {groups} groups of {S} = {groups * S} rows a "
          f"micro-batch, {accum} micro-batches a step, joint L "
          f"{TXT_LEN + NUM_BB}: {np.median(ms):.1f} ms/step median over "
          f"{len(ms)} timed steps ({groups * S * accum / np.median(ms) * 1e3:.0f}"
          f" rows/s); the loader's batch assembly on the host "
          f"{np.median(loads) * 1e3:.1f} ms a step median "
          f"({min(loads) * 1e3:.1f}-{max(loads) * 1e3:.1f}, {len(loads)} "
          f"steps); peak memory of steps 1-3 {peak:.2f} GiB [{card}]")
    itm_launches("recipe", cfg, calls, ITM_STEPS, accum, counts)
    (step, got), = restored or [(None, {})]
    diff = [k for k in saved if k not in got or not torch.equal(got[k],
                                                                saved[k])]
    if step != ITM_STOP or diff or set(got) != set(saved):
        fail(f"itm: the resumed run did not load step {ITM_STOP}'s state bit "
             f"for bit (step {step}; {len(diff)} tensors differ: {diff[:3]})")
    else:
        print(f"  the resumed run loaded step {ITM_STOP}'s parameters and "
              f"AdamW moments bit for bit ({len(saved)} tensors) and went on "
              f"to step {second.step}")
    if second.step != ITM_STEPS or set(second.results) != {"coco_en_test",
                                                           "coco_zh_test"}:
        fail(f"itm: the resumed run ended at step {second.step} with tests "
             f"{sorted(second.results)}")
    with open(os.path.join(out, "test_results.json")) as f:
        if json.load(f) != second.results:
            fail("itm: test_results.json is not the run's results")
    del second, saved, got, restored
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) with hard negatives: sample size 5, 5 steps, mined before step 1
    # and after step 3
    out = os.path.join(ITM_DIR, "hard")
    calls, loads = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_scores(calls), timed_loader(loads):
        run = run_itm(itm_argv(out, stores, ckpt, "--hard_neg_size", "1",
                               "--hard_neg_steps", str(ITM_STOP),
                               "--eval_batch_size", str(ITM_HARD_EVAL_BATCH),
                               "--num_train_steps", str(ITM_HARD_STEPS),
                               "--save_steps", str(10 * ITM_STEPS)))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = launch_counts()
    add(counts)
    print(f"  hard negatives (--hard_neg_size 1 --hard_neg_steps {ITM_STOP};"
          f" cuts: --num_train_steps {ITM_HARD_STEPS}, --eval_batch_size "
          f"{ITM_HARD_EVAL_BATCH}, no restore.ckpt)"
          f": sample size {run.sample_size}, the loader's batch assembly "
          f"{np.median(loads) * 1e3:.1f} ms a step median, peak memory "
          f"{peak:.2f} GiB")
    hard_ms = itm_run_report("hard negatives", run, card,
                             {ITM_STOP, ITM_HARD_STEPS})
    itm_launches("hard negatives", cfg, calls, ITM_HARD_STEPS, accum, counts)
    want = [f"hard_negs_{s}.db{k}.json" for s in (0, ITM_STOP)
            for k in range(4)]
    got = sorted(f for f in os.listdir(out) if f.startswith("hard_negs"))
    if run.sample_size != 5 or got != sorted(want):
        fail(f"itm: hard-negative run: sample size {run.sample_size}, mining "
             f"files {got}")
    for name in got:
        with open(os.path.join(out, name)) as f:
            pools = json.load(f)
        if not pools["txt2hardimgs"] or not pools["img2hardtxts"]:
            fail(f"itm: {name} holds empty pools")
    del run
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the training kernels at the micro-batches' shapes and the
    # inference kernels at B = 300, (f) a rank step twice and against the
    # eager path, (g) scoring pairs/s at B = 300
    print("  the training attention kernels at the micro-batches' shapes:")
    itm_train_kernels(rows, gen)
    print(f"  the inference kernels at the config's batch of "
          f"{ITM_EVAL_BATCH}:")
    itm_kernels_at_300(rows, gen)
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    itm_pairs_per_s(model, stores, card)
    del model
    batch = rank_batch(stores, S, ic["train_batch_size"] // S, accum, 3)
    alone = rank_step_checks(cfg, start, batch, S)
    print(f"  ms/step medians: recipe {np.median(ms):.1f}, hard negatives "
          f"{np.median(hard_ms):.1f}, the step alone {alone:.1f} [{card}]")
    del start, batch
    torch.cuda.empty_cache()
    return total


# ------------------------------------- the VQA, VE and NLVR2 finetuning
FT_DIR = os.path.join("build", "finetune_smoke")
# VQA and VE: 128 images of uc2-base's widths with 2 questions each (a
# training and a validation text store over them, other targets); NLVR2:
# 64 images with 2 statements each, token ids below uniter-base's 30522
FT_IMGS, NL_IMGS = 128, 64
FT_STEPS, FT_STOP = 6, 3
NLVR2_CONFIG = "config/uniter-base.json"
# the VQA loss sums the BCE over 3129 answers (~2.2e3 a row at init), so
# its dropout-0 step is held relative to the fp32 path's loss: 1e-4 of it,
# about 7x the distance that bf16 logits' rounding predicts (1.5e-5)
VQA_LOSS_RTOL = 1e-4


def finetune_stores():
    """Under FT_DIR: the VQA image store (2048-d fp16 features, 10-100
    boxes) with its training and validation questions (answers among
    ans2label.json's 3129, scores from get_score) and VE's (3 answers);
    NLVR2's image store and statements (two images each, 'split-####-#-#'
    identifiers in consistency groups of 4) with annotations.jsonl."""
    vq = synth_corpus(os.path.join(FT_DIR, "vqa_src"), n_imgs=FT_IMGS,
                      seed=30)
    nl = synth_corpus(os.path.join(FT_DIR, "nlvr2_src"), n_imgs=NL_IMGS,
                      seed=31, vocab=30522)
    texts = {name: synth_finetune_texts(os.path.join(FT_DIR, name),
                                        src["txt_db"], task, seed=seed,
                                        **kw)
             for name, src, task, seed, kw in (
                 ("vqa", vq, "vqa", 32, {}), ("vqa_val", vq, "vqa", 33, {}),
                 ("ve", vq, "vqa", 34, {"num_answer": 3}),
                 ("nlvr2", nl, "nlvr2", 35, {}))}
    return {"img": vq["img_db"], "nl_img": nl["img_db"],
            "vqa": texts["vqa"]["txt_db"],
            "vqa_val": texts["vqa_val"]["txt_db"],
            "ve": texts["ve"]["txt_db"], "nlvr2": texts["nlvr2"]["txt_db"],
            "annotations": texts["nlvr2"]["annotations"]}


def run_driver(module, argv):
    """``module.main`` as ``python -m uc2_torch.<module> argv`` runs it, in
    this process."""
    return module.main(module.parse_with_config(module.build_parser(), argv))


@contextlib.contextmanager
def recorded_logits(calls):
    """Record (deterministic, joint L, rows) of every ``logits`` call of the
    VQA and NLVR2 models: the training forwards, the validation and the
    prediction sweep."""
    origs = {cls: cls.logits for cls in (UC2ForVqa, UC2ForNlvr2)}

    def wrap(orig):
        def logits(self, batch, deterministic=True, rng=None):
            calls.append((deterministic, batch["attn_mask"].shape[1],
                          batch["attn_mask"].shape[0]))
            return orig(self, batch, deterministic, rng)
        return logits
    for cls, orig in origs.items():
        cls.logits = wrap(orig)
    try:
        yield
    finally:
        for cls, orig in origs.items():
            cls.logits = orig


def finetune_launches(what, cfg, calls, steps, counts):
    """A run's launches against the routing: 12 each of #5, #6a, #6b a
    training step (one forward a step), and for each deterministic
    forward the gates' kernels at its joint length; nothing else."""
    layers = cfg.num_hidden_layers
    train = [L for det, L, _ in calls if not det]
    want = no_launches()
    for k in TRAIN_KERNELS:
        want[k.__name__] = len(train) * layers
    for det, L, _ in calls:
        if det:
            for k, n in gate_launches(cfg, L).items():
                want[k] += n
    evals = sorted({(L, r) for det, L, r in calls if det})
    print(f"  {what}: {len(train)} training forwards at L "
          f"{sorted(set(train))}, {len(calls) - len(train)} deterministic "
          f"batches at (L, rows) {evals}; launches "
          f"{ {k: n for k, n in counts.items() if n} }")
    if len(train) != steps or counts != want:
        fail(f"{what}: launched {counts}, the routing wants "
             f"{ {k: n for k, n in want.items() if n} } ({len(train)} "
             f"training forwards for {steps} steps)")


def finetune_report(what, run, rows, peak, card, skip=()):
    """ms/step of the loop (median and range, the intervals that hold no
    validation or save), rows/s, the losses and the peak memory; returns
    the timed steps' ms."""
    ms = sorted(r[0] for r in loop_times(run, set(skip)))
    bad = [(s, v) for s, v in run.losses if not np.isfinite(v)]
    print(f"  {what}: steps {[s for s, _ in run.losses]}, losses "
          f"{[round(v, 4) for _, v in run.losses]}; "
          + (f"{np.median(ms):.1f} ms/step median ({ms[0]:.1f}-{ms[-1]:.1f})"
             f" over {len(ms)} timed steps, {rows / np.median(ms) * 1e3:.0f}"
             f" rows/s ({rows} rows a step)" if ms else "no timed step")
          + f"; peak memory {peak:.2f} GiB [{card}]")
    if bad or not run.losses:
        fail(f"{what}: non-finite or no losses {bad}")
    return ms


def score_nlvr2(csv_path, ann):
    """``python -m uc2_torch.eval_nlvr2 csv ann`` in this process: (exit
    code, printed lines)."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            eval_nlvr2.main(csv_path, ann)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue().splitlines()


def real_bias(batch):
    """The additive attention bias of a collated batch's padding mask."""
    m = torch.from_numpy(batch["attn_mask"]).float().cuda()
    return ((1.0 - m) * -10000.0)[:, None, None, :].contiguous()


def finetune_kernels(rows, gen, masks):
    """#2 and #3 at the drivers' deterministic shapes, (32, 262) (NLVR2
    triplet) and (64, 162) (VQA, NLVR2 paired), with the padding masks of
    real batches, each against its plain version and timed beside its
    bound (from CUDA graphs too at L = 262); #5 and #6's passes at
    (32, 262), rates 0.1 and 0, and timed beside SDPA."""
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)
    w1 = (torch.randn(FF, H, generator=gen, device="cuda") * 0.05).bfloat16()
    w2 = (torch.randn(H, FF, generator=gen, device="cuda") * 0.05).bfloat16()
    b1, b2 = vec(gen, FF, 0.02), vec(gen, H, 0.02)
    for bias in masks:
        b, L = bias.shape[0], bias.shape[-1]
        q, k, v, _ = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        run_case(rows, "fused_attn_block", b, L, fused_attn_block,
                 fused_attn_block_plain,
                 (q, k, v, bias, x, wo, bo, gamma, beta),
                 *block_bytes_flops(b, L), graph=L > 162)
        run_case(rows, "fused_ffn_block", b, L, fused_ffn_block,
                 fused_ffn_block_plain, (x, w1, b1, w2, b2, gamma, beta),
                 2 * b * L * H * 2 + 2 * H * FF * 2 + (FF + 3 * H) * 4,
                 4 * b * L * H * FF, graph=L > 162)
        del q, k, v, x
    b, L = masks[0].shape[0], masks[0].shape[-1]
    train_kernels_at(rows, gen, ((b, L),))
    q, k, v, bias = heads(gen, b, L)
    g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
    time_fwd(f"B={b} L={L} rate=0.1", q, k, v, bias, 0.1)
    time_bwd(f"B={b} L={L} rate=0.1", q, k, v, bias, g, 0.1)
    del q, k, v, bias, g
    torch.cuda.empty_cache()


def phase_finetune(card, rows, gen):
    """``python -m uc2_torch.vqa``, ``uc2_torch.ve`` and ``uc2_torch.nlvr2``
    (all three formats) with ``uc2_torch.eval_nlvr2`` in this process on
    U2S stores at the reference's widths (uc2-base and uniter-base at full
    width); #2, #3, #5 and #6 at the drivers' shapes; a VQA step repeated
    and against the eager path. Returns the launches of its runs."""
    print(f"== finetune: python -m uc2_torch.vqa / ve / nlvr2 on U2S stores, "
          f"uc2-base and uniter-base at full width [{card}]")
    shutil.rmtree(FT_DIR, ignore_errors=True)
    try:
        return _phase_finetune(card, rows, gen)
    finally:
        shutil.rmtree(FT_DIR, ignore_errors=True)


def _phase_finetune(card, rows, gen):
    t0 = time.perf_counter()
    stores = finetune_stores()
    nl_cfg = UC2Config.from_json_file(NLVR2_CONFIG)
    ckpt = os.path.join(FT_DIR, "uniter_encoder.pt")
    enc = UC2ForImageTextRetrieval(nl_cfg, device="cuda", seed=1)
    torch.save({k: v.cpu() for k, v in enc.state_dict().items()
                if k.startswith("roberta.")}, ckpt)
    del enc
    print(f"  stores (VQA/VE: {FT_IMGS} images, 2048-d fp16 features, 10-100 "
          f"boxes, 2 questions each, answers among ans2label.json's 3129; "
          f"NLVR2: {NL_IMGS} images, 2 statements each over two images, "
          f"vocab 30522) and a uniter-base encoder checkpoint (two token "
          f"types) written in {time.perf_counter() - t0:.1f} s")
    total = no_launches()

    def add(counts):
        for k, n in counts.items():
            total[k] += n

    def start_count():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()

    def peak_gib():
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2 ** 30

    # (a) VQA: 3 steps with validation, a milestone and restore.ckpt at 3,
    # resumed to 6; then one validation alone
    out = os.path.join(FT_DIR, "run_vqa")
    base = ["--train_txt_db", stores["vqa"], "--train_img_db", stores["img"],
            "--val_txt_db", stores["vqa_val"], "--val_img_db", stores["img"],
            "--output_dir", out, "--valid_steps", str(FT_STOP),
            "--save_steps", str(FT_STOP), "--log_steps", "1"]
    print(f"  vqa: defaults of python -m uc2_torch.vqa (config/uc2-base.json,"
          f" batch 64, lr 8e-5, --decay linear, ans2label.json, "
          f"--val_batches 8, bf16, dropout 0.1) with the stores above and "
          f"--num_train_steps {FT_STOP} --valid_steps {FT_STOP} --save_steps "
          f"{FT_STOP} --log_steps 1, then --num_train_steps {FT_STEPS}")
    calls = []
    start_count()
    with recorded_logits(calls):
        first = run_driver(vqa, base + ["--num_train_steps", str(FT_STOP)])
        peak = peak_gib()
        saved = itm_state(first.model, first.optimizer)
        cfg = first.model.config
        ms = finetune_report("vqa, steps 1-3", first, 64, peak, card)
        first_val = first.val
        del first
        torch.cuda.empty_cache()
        restored = []
        real = itm_checkpoint.TrainingRestorer.restore

        def restore(self, model, opt):
            step = real(self, model, opt)
            restored.append((step, itm_state(model, opt)))
            return step
        itm_checkpoint.TrainingRestorer.restore = restore
        torch.cuda.reset_peak_memory_stats()
        try:
            second = run_driver(vqa, base + ["--num_train_steps",
                                             str(FT_STEPS)])
        finally:
            itm_checkpoint.TrainingRestorer.restore = real
    counts = launch_counts()
    add(counts)
    ms += finetune_report("vqa, resumed, steps 4-6", second, 64, peak_gib(),
                          card)
    ms.sort()
    print(f"  vqa: {np.median(ms):.1f} ms/step median ({ms[0]:.1f}-"
          f"{ms[-1]:.1f}) over {len(ms)} timed steps, "
          f"{64 / np.median(ms) * 1e3:.0f} rows/s at (64, "
          f"{TXT_LEN + NUM_BB}); validation soft scores "
          f"{[(s, round(v, 4)) for s, v in first_val + second.val]} [{card}]")
    finetune_launches("vqa", cfg, calls, FT_STEPS, counts)
    (step, got), = restored or [(None, {})]
    diff = [k for k in saved if k not in got or not torch.equal(got[k],
                                                                saved[k])]
    if step != FT_STOP or diff or set(got) != set(saved):
        fail(f"vqa: the resumed run did not load step {FT_STOP}'s state bit "
             f"for bit (step {step}; {len(diff)} tensors differ: {diff[:3]})")
    else:
        print(f"  the resumed vqa run loaded step {FT_STOP}'s parameters and "
              f"AdamW moments bit for bit ({len(saved)} tensors) and went on "
              f"to step {second.step}")
    if (second.step != FT_STEPS or [s for s, _ in first_val + second.val]
            != [FT_STOP, FT_STEPS]
            or sorted(os.listdir(os.path.join(out, "ckpt")))
            != [f"model_step_{s}.pt" for s in (FT_STOP, FT_STEPS)]):
        fail(f"vqa: the runs ended at step {second.step} with validations "
             f"{first_val + second.val} and milestones "
             f"{sorted(os.listdir(os.path.join(out, 'ckpt')))}")
    opts = vqa.parse_with_config(vqa.build_parser(), base)
    opts.num_answer = second.model.num_answer
    val_ds = datasets.VqaDataset(
        db.TxtTokDb(stores["vqa_val"], max_txt_len=opts.max_txt_len),
        db.DetectFeatDb(stores["img"], opts.conf_th, opts.max_bb,
                        opts.min_bb, opts.num_bb),
        num_answers=opts.num_answer)
    vqa.validate(second.model, val_ds, opts, "cuda")     # warm
    calls = []
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with recorded_logits(calls):
        score = vqa.validate(second.model, val_ds, opts, "cuda")
    sec = time.perf_counter() - t1
    counts = launch_counts()
    add(counts)
    n_rows = sum(r for _, _, r in calls)
    print(f"  one vqa validation alone: soft score {score:.4f}, "
          f"{len(calls)} batches of 32 in {sec * 1e3:.1f} ms "
          f"({n_rows / sec:.0f} rows/s) [{card}]")
    finetune_launches("vqa validation", cfg, calls, 0, counts)
    if not (0.0 <= score <= 1.0) or len(calls) != opts.val_batches:
        fail(f"vqa: validation gave {score} over {len(calls)} batches")
    del second, saved, got, restored
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # (b) VE: 3 steps
    out = os.path.join(FT_DIR, "run_ve")
    calls = []
    start_count()
    with recorded_logits(calls):
        run = run_driver(ve, ["--train_txt_db", stores["ve"],
                              "--train_img_db", stores["img"],
                              "--output_dir", out, "--num_train_steps",
                              str(FT_STOP), "--log_steps", "1"])
    counts = launch_counts()
    add(counts)
    ve_ms = finetune_report("ve (3 answers), steps 1-3", run, 64, peak_gib(),
                            card)
    finetune_launches("ve", run.model.config, calls, FT_STOP, counts)
    if run.model.num_answer != 3 or run.step != FT_STOP:
        fail(f"ve: {run.model.num_answer} answers, step {run.step}")
    del run
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) NLVR2 in its three formats: 3 steps each from the encoder
    # checkpoint, the prediction sweep into --pred_csv, the scorer
    with open(stores["annotations"]) as f:
        ids = [json.loads(line)["identifier"] for line in f]
    nl_ms, pred_times = {}, []
    real_predict = nlvr2.predict

    def predict(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out_ = real_predict(*a)
        pred_times.append(time.perf_counter() - t)
        return out_
    nlvr2.predict = predict
    try:
        for fmt in ("triplet", "paired", "paired-attn"):
            out = os.path.join(FT_DIR, f"run_nlvr2_{fmt}")
            csv_path = out + ".csv"
            calls = []
            start_count()
            with recorded_logits(calls):
                run = run_driver(nlvr2, [
                    "--train_txt_db", stores["nlvr2"], "--train_img_db",
                    stores["nl_img"], "--fmt", fmt, "--checkpoint", ckpt,
                    "--pred_csv", csv_path, "--output_dir", out,
                    "--num_train_steps", str(FT_STOP), "--log_steps", "1"])
            counts = launch_counts()
            add(counts)
            n_rows = 32 if fmt == "triplet" else 64
            nl_ms[fmt] = finetune_report(
                f"nlvr2 {fmt}, steps 1-3", run, n_rows, peak_gib(), card)
            finetune_launches(f"nlvr2 {fmt}", run.model.config, calls,
                              FT_STOP, counts)
            pred_rows = sum(r for det, _, r in calls if det)
            print(f"  nlvr2 {fmt} prediction sweep: {len(run.preds)} "
                  f"predictions, {pred_rows} rows in "
                  f"{pred_times[-1] * 1e3:.1f} ms "
                  f"({pred_rows / pred_times[-1]:.0f} rows/s) [{card}]")
            with open(csv_path) as f:
                csv_ids = [line.split(",")[0] for line in f.read().split()]
            code, lines = score_nlvr2(csv_path, stores["annotations"])
            print(f"  python -m uc2_torch.eval_nlvr2 "
                  f"{os.path.basename(csv_path)} annotations.jsonl: exit "
                  f"{code}, {lines}")
            parsed = dict(line.split("=", 1) for line in lines
                          if "=" in line)
            try:
                acc = float(parsed["accuracy"])
                cons = float(parsed["consistency"])
            except (KeyError, ValueError):
                acc = cons = float("nan")
            if (code != 0 or csv_ids != ids or not 0 <= acc <= 1
                    or not 0 <= cons <= 1 or run.step != FT_STOP):
                fail(f"nlvr2 {fmt}: step {run.step}, {len(csv_ids)} of "
                     f"{len(ids)} identifiers in the CSV, scorer exit {code} "
                     f"{lines}")
            del run
            shutil.rmtree(out, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        nlvr2.predict = real_predict

    # (d) the kernels at the new shapes, (e) a VQA step twice and against
    # the eager path
    def first_batch(ds, nb, bsz):
        return TaskLoader("finetune", ds, [BucketSpec(TXT_LEN, nb, bsz, 0)],
                          seed=5).next_batch()
    vtxt = db.TxtTokDb(stores["vqa"])
    vimg = db.DetectFeatDb(stores["img"])
    vbatch = first_batch(datasets.VqaDataset(vtxt, vimg, 3129), NUM_BB, 64)
    tbatch = first_batch(datasets.Nlvr2PairedDataset(
        db.TxtTokDb(stores["nlvr2"]), db.DetectFeatDb(stores["nl_img"])),
        2 * NUM_BB, 32)
    print("  the inference kernels at the drivers' deterministic shapes and "
          "the training attention at the triplet's:")
    finetune_kernels(rows, gen, (real_bias(tbatch), real_bias(vbatch)))
    put = task_batch_to_device("cuda")
    _, batch = put(("vqa", vbatch))

    def make(c):
        return UC2ForVqa(c, 3129, device="cuda", seed=0)
    model = make(cfg)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    alone = step_checks("vqa", make, cfg, start, batch, "vqa",
                        loss_rtol=VQA_LOSS_RTOL)
    print(f"  ms/step medians: vqa {np.median(ms):.1f}, ve "
          f"{np.median(ve_ms):.1f}, nlvr2 "
          + ", ".join(f"{f} {np.median(m):.1f}" for f, m in nl_ms.items())
          + f"; the vqa step alone {alone:.1f} [{card}]")
    del start, batch
    torch.cuda.empty_cache()
    return total


# ------------------------------------------- data parallelism across processes
DIST_DIR = os.path.join("build", "dist_smoke")
DIST_IMGS = 128
DIST_STEPS, DIST_STOP = 2, 1
# one step split over two processes against the same batch in one: the
# two sum their gradients in another order (and cuBLAS picks its products
# for 64 rows, not 128)
DIST_NORM_RTOL = 1e-3
# the split step's loss sums the same fp32 token losses in another order
# (each row's forward is the same at 64 rows as at 128: the H100 read a
# |diff| of 0), so it sits within a few ulps (9.5e-7 at 12.6) of one
# process's loss; 2e-6 leaves ~25 ulps and still sees a per-process
# normaliser (the mean of the processes' means, 5.1e-5 away on this
# batch), whose gap the phase prints beside it
DIST_LOSS_RTOL = 2e-6
DIST_TIMEOUT = 600       # seconds a spawned process may take


def dist_config():
    """uc2-base under "pallas-train", written under DIST_DIR."""
    with open("config/uc2-base.json") as f:
        cfg = dict(json.load(f), use_pallas_attention="pallas-train")
    path = os.path.join(DIST_DIR, "uc2-base-pallas-train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


# free_port and spawn are kin of tests/torch_dist_util.py's, kept here
# because this script imports nothing from tests/ and spawns commands
# (module runs and worker scripts) that report through their exit codes
def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(argvs, timeout=DIST_TIMEOUT):
    """Start one process per argv (the repository on the path), wait for
    all; each is killed at ``timeout`` seconds. Returns [(rc, output)]."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = [subprocess.Popen(a, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    out = []
    t0 = time.perf_counter()
    try:
        for p in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                text, _ = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                text += f"\n(killed after {timeout} s)"
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def spawned_ok(what, res):
    """True when every process exited 0; else the failure, with the tail of
    each process's output."""
    if all(rc == 0 for rc, _ in res):
        return True
    for r, (rc, text) in enumerate(res):
        print(f"  {what}, process {r} (rc {rc}):\n"
              + "\n".join("    " + ln for ln in text.splitlines()[-25:]))
    fail(f"dist: {what} failed")
    return False


def worker(name, body):
    """A worker script under DIST_DIR: ``python <script> rank addr dir``."""
    path = os.path.join(DIST_DIR, f"{name}.py")
    with open(path, "w") as f:
        f.write(body)
    return path


DIST_PROBE = r"""
import json, sys, torch
rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import torch.distributed as dist
from uc2_torch.parallel import multihost as MH
assert MH.maybe_initialize(addr, 2, rank, backend="gloo", device="cuda",
                           timeout_s=30)
x = torch.full((8,), float(rank + 1), device="cuda")
out = {}
def probe(name, fn):
    try:
        fn()
        torch.cuda.synchronize()
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
    json.dump(out, open(f"{d}/probe_{rank}.json", "w"))
    dist.barrier()
probe("all_reduce", lambda: dist.all_reduce(x.clone()))
probe("broadcast", lambda: dist.broadcast(x.clone(), 0))
probe("all_gather", lambda: dist.all_gather(
    [torch.empty_like(x) for _ in range(2)], x))
probe("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
    torch.empty(16, device="cuda"), x))
probe("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
    torch.empty(4, device="cuda"), x))
probe("reduce_scatter", lambda: dist.reduce_scatter(
    torch.empty(4, device="cuda"), list(x.chunk(2))))
probe("all_to_all_single", lambda: dist.all_to_all_single(
    torch.empty_like(x), x))
MH.shutdown()
"""

DIST_STEP = r"""
import hashlib, json, sys, time
import torch
rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from uc2_torch.parallel import mesh as M, multihost as MH
assert MH.maybe_initialize(addr, 2, rank, backend="gloo", device="cuda")
torch.backends.cuda.matmul.allow_tf32 = False
from uc2_torch.config import UC2Config
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import flash_attention as fa
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training.optim import build_optimizer, constant
from uc2_torch.training.step import train_step
from uc2_torch.utils import flops, profiling
from uc2_torch.utils.misc import set_dropout
KS = (fa.flash_attention_train_fwd, fa.flash_attention_train_bwd_dq,
      fa.flash_attention_train_bwd_dkdv)
meta = json.load(open(f"{d}/meta.json"))
cfg = set_dropout(UC2Config.from_json_file(meta["model_config"]).replace(
    dtype="bfloat16"), 0.0)
batch = torch.load(f"{d}/batch.pt", weights_only=True)
h = batch["input_ids"].shape[0] // 2
local = {k: v[rank * h:(rank + 1) * h].to("cuda") for k, v in batch.items()}
model = UC2ForPretraining(cfg, device="cuda", seed=0)
M.broadcast_params(model)
start = {k: v.clone() for k, v in model.state_dict().items()}
spent = {"all_reduce": 0.0, "all_gather": 0.0}
calls = {"all_reduce": 0, "all_gather": 0}
def timed(name, fn):
    def f(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a)
        torch.cuda.synchronize()
        spent[name] += (time.perf_counter() - t0) * 1e3
        calls[name] += 1
        return r
    return f
M._all_reduce = timed("all_reduce", M._all_reduce)
M.all_gather_flat = timed("all_gather", M.all_gather_flat)
out, params = {}, {}
for zero1 in (False, True):
    model.load_state_dict(start)
    opt = build_optimizer(model, constant(1e-4), weight_decay=0.0,
                          betas=(0.9, 0.98), grad_norm=2.0, zero1=zero1)
    rows = []
    for i in range(3):
        for k in KS:
            k.launches = 0
        for k in spent:
            spent[k], calls[k] = 0.0, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, local, DropoutRng(7, "cuda"), task="mlm")
        torch.cuda.synchronize()
        rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "loss": m["loss"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "n_units": m["n_units"].item(),
                     "collective_ms": dict(spent),
                     "collectives": dict(calls),
                     "launches": {k.__name__: k.launches for k in KS}})
        if i == 0:
            params[zero1] = [p.detach().clone() for p in model.parameters()]
    out["zero1" if zero1 else "replicated"] = rows
    out[("zero1" if zero1 else "replicated") + "_moments"] = sum(
        st["exp_avg"].numel() for st in opt.opt.state.values())
    del opt
out["total"] = sum(p.numel() for p in model.parameters())
out["bitwise"] = all(torch.equal(a, b) for a, b in
                     zip(params[False], params[True]))
sha = hashlib.sha1()
for p in params[True]:
    sha.update(p.cpu().numpy().tobytes())
out["sha1"] = sha.hexdigest()
json.dump(out, open(f"{d}/step_{rank}.json", "w"))
MH.shutdown()
"""

DIST_DRIVER = r"""
import json, os, sys, time
rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import numpy as np, torch
from uc2_torch import pretrain
from uc2_torch.ops import dropout as D, flash_attention as fa
from uc2_torch.parallel import mesh as M, multihost as MH
from uc2_torch.training import checkpoint as C
KS = (fa.flash_attention_train_fwd, fa.flash_attention_train_bwd_dq,
      fa.flash_attention_train_bwd_dkdv)
from uc2_torch.parallel import tensor as TP
spent = {"ms": 0.0, "n": 0}
ar0 = TP._all_reduce
def ar(t, *a, **k):
    # the model group's all-reduces (tensor parallelism), timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ar0(t, *a, **k)
    torch.cuda.synchronize()
    spent["ms"] += (time.perf_counter() - t0) * 1e3
    spent["n"] += 1
    return r
TP._all_reduce = ar
meta = json.load(open(f"{d}/meta.json"))
argv = meta["driver_argv"] + [
    "--coordinator_address", addr, "--num_processes", "2",
    "--process_id", str(rank), "--dist_backend", "gloo"] + meta.get(
    "extra", ["--zero1"])
seeds = []
init0 = D.DropoutRng.__init__
def init(self, seed, device="cuda"):
    seeds.append(seed)
    init0(self, seed, device)
D.DropoutRng.__init__ = init
restored = {}
restore0 = C.TrainingRestorer.restore
def restore(self, model, opt):
    step = restore0(self, model, opt)
    restored.update(step=step, model=C.host_copy(model.state_dict()),
                    opt=C.host_copy(opt.state_dict()))
    return step
C.TrainingRestorer.restore = restore
def run(a):
    opts = pretrain.parse_with_config(pretrain.build_parser(), a)
    pretrain.apply_reference_config_compat(opts, a)
    return pretrain.main(opts)
def same(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b
for k in KS:
    k.launches = 0
first = run(argv + ["--stop_after_steps", str(meta["stop"])])
torch.cuda.synchronize()
launches = {k.__name__: k.launches for k in KS}
saved = (C.host_copy(first.model.state_dict()),
         C.host_copy(first.optimizer.state_dict()))     # a gather
own = sum(v.numel() for t in first.optimizer.opt.state.values()
          for k, v in t.items() if k == "exp_avg")
out = {"first": {"step": first.step, "losses": first.losses,
                 "logs": first.logs, "saves": first.save_seconds},
       "launches_first": launches, "own_moments": own,
       "total": sum(p.numel() for p in first.model.parameters()),
       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
del first
torch.cuda.empty_cache()
second = run(argv)
torch.cuda.synchronize()
out["second"] = {"step": second.step, "losses": second.losses,
                 "logs": second.logs, "saves": second.save_seconds}
out["restored_step"] = restored.get("step")
out["model_bitwise"] = same(restored.get("model"), saved[0])
out["optimizer_bitwise"] = same(restored.get("opt"), saved[1])
out["streams"] = [os.path.exists(os.path.join(
    meta["driver_out"], f"restore_stream_p{r}.json")) for r in (0, 1)]
out["step1_seed"] = seeds[0]
keep = D.dropout(torch.ones(1 << 16, device="cuda"), 0.1,
                 D.DropoutRng(seeds[0], "cuda")) > 0
np.save(f"{d}/keep_{rank}.npy", keep.cpu().numpy())
out["collective"] = dict(spent)
json.dump(out, open(f"{d}/driver_{rank}.json", "w"))
MH.shutdown()
"""

DIST_NCCL_PAIR = r"""
import sys
from uc2_torch.parallel import multihost as MH
MH.maybe_initialize(sys.argv[2], 2, int(sys.argv[1]), device="cuda")
"""


def dist_driver_argv(out, corpus, model_config, *extra):
    """config/uc2_pretrain.json's mix on the phase's stores at uc2-base
    under "pallas-train": DIST_STEPS steps, a log line a step, no
    validation."""
    return pretrain_argv(out, corpus, "--model_config", model_config,
                         "--num_train_steps", str(DIST_STEPS),
                         "--valid_steps", "0", *extra)


def scalars_losses(out):
    """[(step, task, loss)] of a run's log/scalars.jsonl."""
    got = []
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k.startswith("step_loss/"):
                    got.append((rec["step"], k[len("step_loss/"):], v))
    return got


def ckpt_state(path):
    """``trained_state``'s dict from a restore.ckpt."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"param {k}": v for k, v in sd["model"].items()}
    for i, st in sd["optimizer"]["state"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "exp_inf"):
            if k in st:
                out[f"{k} {i}"] = st[k]
    return sd["global_step"], out


def phase_dist(card, rows, gen):
    """Data-parallel training across processes on the one card (the
    module's docstring, phase 18). Returns the launches of the runs."""
    print(f"== dist: data parallelism across processes (uc2_torch.parallel)"
          f", uc2-base under pallas-train, config/uc2_pretrain.json's mix "
          f"[{card}]")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    try:
        return _phase_dist(card, rows, gen)
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
        torch.cuda.empty_cache()


def _phase_dist(card, rows, gen):
    launches = no_launches()
    # a process's rows of the split batch
    train_kernels_at(rows, gen, ((B, TXT_LEN + NUM_BB),))
    torch.cuda.empty_cache()
    py = sys.executable

    # two NCCL ranks on one card: refused at start, never a hang
    addr = f"127.0.0.1:{free_port()}"
    res = spawn([[py, worker("nccl_pair", DIST_NCCL_PAIR), str(r), addr]
                 for r in (0, 1)], timeout=120)
    named = [rc != 0 and "--dist_backend gloo" in text for rc, text in res]
    print(f"  two NCCL ranks on one card: exit codes "
          f"{[rc for rc, _ in res]}, refusal naming --dist_backend gloo "
          f"{named}")
    if not all(named):
        fail("dist: two NCCL ranks on one card were not refused by name")

    cfg_path = dist_config()
    t0 = time.perf_counter()
    corpus = [synth_corpus(os.path.join(DIST_DIR, lang), n_imgs=DIST_IMGS,
                           txt_per_img=2, seed=seed, paired=lang == "de")
              for lang, seed in (("en", 0), ("de", 1))]
    print(f"  stores: en and de, {DIST_IMGS} images x 2 captions each, in "
          f"{time.perf_counter() - t0:.1f} s")

    # (a) a world of one over NCCL against no process group
    plain_out = os.path.join(DIST_DIR, "plain")
    torch.cuda.synchronize()
    reset_launches()
    run = run_pretrain(dist_driver_argv(plain_out, corpus, cfg_path,
                                        "--save_steps", "100"))
    torch.cuda.synchronize()
    for k, n in launch_counts().items():
        launches[k] += n
    want = trained_state(run)
    want_losses = [(s, t, v) for s, t, v in run.losses]
    plain_ms = [round(r[0], 1) for r in loop_times(run, set())]
    del run
    torch.cuda.empty_cache()
    one_out = os.path.join(DIST_DIR, "world1")
    t0 = time.perf_counter()
    res = spawn([[py, "-m", "uc2_torch.pretrain",
                  *dist_driver_argv(one_out, corpus, cfg_path,
                                    "--save_steps", str(DIST_STEPS)),
                  "--coordinator_address", f"127.0.0.1:{free_port()}",
                  "--num_processes", "1", "--process_id", "0", "--zero1"]])
    one_s = time.perf_counter() - t0
    if spawned_ok("the world-1 NCCL run", res):
        step, got = ckpt_state(os.path.join(one_out, "restore.ckpt"))
        got_losses = scalars_losses(one_out)
        diff = sorted(k for k in want if k not in got
                      or not torch.equal(got[k], want[k]))
        ok = (step == DIST_STEPS and not diff and len(got) == len(want)
              and got_losses == want_losses)
        print(f"  (a) python -m uc2_torch.pretrain --coordinator_address "
              f"... --num_processes 1 --process_id 0 --zero1 (NCCL): "
              f"{DIST_STEPS} steps in {one_s:.1f} s with the process's "
              f"start; losses {[(s, t, round(v, 4)) for s, t, v in got_losses]}"
              f"; against the run without a process group (loop ms/step "
              f"{plain_ms}): losses equal {got_losses == want_losses}, "
              f"{len(want) - len(diff)} of {len(want)} parameter and moment "
              f"tensors bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"dist: the world-1 NCCL run is not the run without a "
                 f"process group bit for bit ({diff[:3]}, step {step})")
        del got
    del want
    shutil.rmtree(one_out, ignore_errors=True)
    shutil.rmtree(plain_out, ignore_errors=True)

    # (b) two processes on the card over gloo
    addr = f"127.0.0.1:{free_port()}"
    res = spawn([[py, worker("probe", DIST_PROBE), str(r), addr, DIST_DIR]
                 for r in (0, 1)], timeout=300)
    probe = {}
    path = os.path.join(DIST_DIR, "probe_0.json")
    if os.path.exists(path):
        with open(path) as f:
            probe = json.load(f)
    print(f"  gloo on CUDA tensors (2 processes, one card; exit codes "
          f"{[rc for rc, _ in res]}): {probe} [{card}]")
    if probe.get("all_reduce") != "ok" or probe.get("all_gather") != "ok":
        fail(f"dist: gloo refused all_reduce or all_gather on CUDA tensors: "
             f"{probe}")

    cfg0 = set_dropout(UC2Config.from_json_file(cfg_path).replace(
        dtype="bfloat16"), 0.0)
    batch = mix_batches(cfg0, 1, TRAIN_SEED)[0]["mlm"][0]
    torch.save({k: v.cpu() for k, v in batch.items()},
               os.path.join(DIST_DIR, "batch.pt"))
    model = UC2ForPretraining(cfg0, device="cuda", seed=0)
    h = batch["input_ids"].shape[0] // 2
    with torch.no_grad():
        halves = [make_loss_fn("mlm")(
            model, {k: v[i * h:(i + 1) * h] for k, v in batch.items()},
            DropoutRng(7, "cuda"))[0].item() for i in (0, 1)]
    opt = build_optimizer(model, constant(1e-4), weight_decay=0.0,
                          betas=(0.9, 0.98), grad_norm=2.0)
    m = train_step(model, opt, batch, DropoutRng(7, "cuda"), task="mlm")
    one_loss, one_norm = m["loss"].item(), m["grad_norm"].item()
    one_units = m["n_units"].item()
    del model, opt, m
    local_gap = abs(sum(halves) / 2 - one_loss)
    loss_lim = min(STEP_LOSS_TOL, DIST_LOSS_RTOL * one_loss)
    print(f"  one process's 128 rows: loss {one_loss:.6f}, {one_units:g} "
          f"masked tokens; the halves' losses {[round(x, 6) for x in halves]}"
          f", so a per-process normaliser would report "
          f"{sum(halves) / 2:.6f} ({local_gap:.2e} away; the split step's "
          f"loss limit {loss_lim:.2e} "
          f"{'sees' if local_gap > loss_lim else 'does NOT see'} it)")
    torch.cuda.empty_cache()
    meta = {"model_config": cfg_path, "stop": DIST_STOP,
            "driver_out": os.path.join(DIST_DIR, "driver"),
            "driver_argv": dist_driver_argv(
                os.path.join(DIST_DIR, "driver"), corpus, cfg_path,
                "--save_steps", str(DIST_STOP),
                # each process's micro-batches half the one-process size:
                # the global batch of the one-process run
                "--train_batch_size", "5120")}
    with open(os.path.join(DIST_DIR, "meta.json"), "w") as f:
        json.dump(meta, f)
    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    res = spawn([[py, worker("step", DIST_STEP), str(r), addr, DIST_DIR]
                 for r in (0, 1)])
    step_s = time.perf_counter() - t0
    if spawned_ok("the two-process step", res):
        outs = []
        for r in (0, 1):
            with open(os.path.join(DIST_DIR, f"step_{r}.json")) as f:
                outs.append(json.load(f))
        for mode in ("replicated", "zero1"):
            for r, o in enumerate(outs):
                rws = o[mode]
                first = rws[0]
                d_loss = abs(first["loss"] - one_loss)
                d_norm = abs(first["grad_norm"] - one_norm) / one_norm
                ok = (d_loss <= loss_lim and d_norm <= DIST_NORM_RTOL
                      and first["n_units"] == one_units
                      and all(n == cfg0.num_hidden_layers
                              for n in first["launches"].values()))
                ms = [round(x["ms"], 1) for x in rws]
                coll = [{k: round(v, 1) for k, v in x["collective_ms"].items()}
                        for x in rws]
                print(f"  (b) {mode}, process {r} of 2 (gloo, 64 of the 128 "
                      f"rows at L = 162, dropout 0): loss {first['loss']:.6f} "
                      f"vs one process's {one_loss:.6f} (|diff| "
                      f"{d_loss:.2e}, tolerance {loss_lim:.2e}), masked "
                      f"tokens over the processes {first['n_units']:g} vs "
                      f"{one_units:g}, grad norm "
                      f"{first['grad_norm']:.6f} vs {one_norm:.6f} (relative "
                      f"{d_norm:.2e}, tolerance {DIST_NORM_RTOL:g}); launches "
                      f"{first['launches']}; ms/step {ms} (the first with "
                      f"the warm-up); collectives' ms a step {coll}, "
                      f"{first['collectives']} a step; moments kept "
                      f"{o[mode + '_moments']} of {o['total']} "
                      f"{'ok' if ok else 'FAIL'} [{card}]")
                if not ok:
                    fail(f"dist: the two-process {mode} step (process {r}) "
                         f"is not the one-process step")
                for name, n in first["launches"].items():
                    launches[name] += n
        ok = all(o["bitwise"] for o in outs) and outs[0]["sha1"] == \
            outs[1]["sha1"]
        share = [o["zero1_moments"] / o["total"] for o in outs]
        print(f"  --zero1 parameters after the step bit for bit the "
              f"replicated step's on both processes, and the processes' "
              f"alike: {ok}; each process keeps {share} of the moments; "
              f"{step_s:.1f} s with the processes' start")
        if not ok:
            fail("dist: the --zero1 step is not the replicated step bit for "
                 "bit")

    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    res = spawn([[py, worker("driver", DIST_DRIVER), str(r), addr, DIST_DIR]
                 for r in (0, 1)])
    drv_s = time.perf_counter() - t0
    if spawned_ok("the two-process driver", res):
        outs = []
        for r in (0, 1):
            with open(os.path.join(DIST_DIR, f"driver_{r}.json")) as f:
                outs.append(json.load(f))
        keeps = [np.load(os.path.join(DIST_DIR, f"keep_{r}.npy"))
                 for r in (0, 1)]
        seed = json.load(open("config/uc2_pretrain.json"))["seed"]
        one = (dropout(torch.ones(1 << 16, device="cuda"), 0.1, DropoutRng(
            pretrain.step_seed(seed, 0), "cuda")) > 0).cpu().numpy()
        masks_ok = (np.array_equal(keeps[0], one)
                    and not np.array_equal(keeps[0], keeps[1]))
        with open("config/uc2_pretrain.json") as f:
            accum = json.load(f)["gradient_accumulation_steps"]
        for r, o in enumerate(outs):
            want_n = DIST_STOP * cfg0.num_hidden_layers * accum
            ok = (o["restored_step"] == DIST_STOP and o["model_bitwise"]
                  and o["optimizer_bitwise"] and all(o["streams"])
                  and o["second"]["step"] == DIST_STEPS
                  and all(n == want_n for n in o["launches_first"].values())
                  and all(np.isfinite(v) for part in ("first", "second")
                          for _, _, v in o[part]["losses"]))
            logs = o["first"]["logs"] + o["second"]["logs"]
            ms = [round((t1 - t0_) * 1e3 / (s1 - s0), 1)
                  for (s0, t0_, _), (s1, t1, _) in zip(logs, logs[1:])
                  if s1 > s0 and s0 != DIST_STOP]
            print(f"  (b) driver, process {r} of 2 (gloo, --zero1, "
                  f"--train_batch_size 5120): steps 1-{DIST_STOP}, saved, "
                  f"resumed to {o['second']['step']}; losses "
                  f"{[(s, t, round(v, 4)) for p in ('first', 'second') for s, t, v in o[p]['losses']]}"
                  f"; restored step {o['restored_step']}, model bit for bit "
                  f"{o['model_bitwise']}, optimizer bit for bit "
                  f"{o['optimizer_bitwise']}; stream files {o['streams']}; "
                  f"launches of steps 1-{DIST_STOP} {o['launches_first']} "
                  f"(want {want_n} each); moments kept {o['own_moments']} of "
                  f"{o['total']}; loop ms/step {ms}; saves "
                  f"{[round(t, 2) for t in o['first']['saves'] + o['second']['saves']]}"
                  f" s; peak {o['peak_gib']:.1f} GiB {'ok' if ok else 'FAIL'}"
                  f" [{card}]")
            if not ok:
                fail(f"dist: the two-process driver run (process {r}) did not "
                     f"resume bit for bit or missed a launch")
            for name, n in o["launches_first"].items():
                launches[name] += n
        print(f"  the processes' first dropout masks: process 0's are the "
              f"one-process masks {np.array_equal(keeps[0], one)}, process "
              f"1's differ from them {not np.array_equal(keeps[0], keeps[1])}"
              f"; keep rates {[round(float(k.mean()), 4) for k in keeps]}; "
              f"{drv_s:.1f} s with the processes' start")
        if not masks_ok:
            fail("dist: the processes' dropout masks are not per process")
    return launches


# ------------------------------------------------------- int8 serving
# (rows, in, out) of the four int8 products of a layer at a scored batch
# of B = 64 at L = 98: qkv, the attention output, the FFN's two products
INT8_PRODUCTS = (("qkv", H, 3 * H), ("attention_output_dense", H, H),
                 ("intermediate_dense", H, FF), ("output_dense", FF, H))
INT8_RTOL = 1e-6
# the card's int8 function against the CPU's exact one, on the first
# INT8_CPU_ROWS pairs of a batch (the CPU's share of the phase's time):
# fp32 noise moves a code by a small part of a step, so it flips only near
# a rounding tie (7e-5 to 9e-5 of the codes, PERF.md, PR 19), and by one
# step; a fault in the card's path (scales, rounding, the route) flips
# most of them
INT8_CODE_SHARE, INT8_CPU_ROWS = 1e-3, 16
# int8 against bf16 scores from the same weights: the batch's rank order
# kept to this Spearman correlation, at every L for each of INT8_TEXTS
# texts and INT8_SEEDS weight draws. tests/test_int8_quant.py holds 0.95
# on a 2-layer model of width 64. At uc2-base width with random weights
# the 24 readings on the card spread from 0.910 to 0.985, and 8 of them
# are below 0.95 (PERF.md, PR 19). The limit sits below the lowest of
# them. The check above, not this one, holds the card to the int8
# function code for code
INT8_RANK_RHO = 0.90
INT8_TEXTS, INT8_SEEDS = 4, (0, 1)
INT8_DIR = os.path.join("build", "int8_smoke")
INT8_STEPS = 2


def spearman(a, b) -> float:
    ra, rb = (np.argsort(np.argsort(x)) for x in (a, b))
    return float(np.corrcoef(ra, rb)[0, 1])


def int8_product_checks(gen, card):
    """Each of a layer's four int8 products at (B, L) = (64, 98) rows on
    the card against its plain version: the codes and the int32 sums
    (cuBLASLt ``_int_mm`` against the CPU's exact product) bit for bit,
    ``int8_linear``'s output within INT8_RTOL; the product timed beside
    the bf16 ``F.linear`` of the same shapes and its int8 bound."""
    rows = B * 98
    for name, K, Nout in INT8_PRODUCTS:
        x = torch.randn(rows, K, generator=gen, device="cuda").bfloat16()
        w = torch.randn(Nout, K, generator=gen, device="cuda") * 0.02
        bias = torch.randn(Nout, generator=gen, device="cuda") * 0.01
        x_q, s_x = int8_ops.quantize_rows(x)
        w_q, s_w = int8_ops.weight_codes(w)
        cx_q, _ = int8_ops.quantize_rows(x.cpu())
        cw_q, _ = int8_ops.quantize_weight(w.cpu())
        sums = int8_ops.int8_product(x_q, w_q)
        plain = int8_ops.int8_product_plain(cx_q, cw_q)
        torch.cuda.synchronize()
        x_off = int((x_q.cpu() != cx_q).sum())
        w_off = int((w_q.cpu() != cw_q).sum())
        codes_ok = x_off == 0 and w_off == 0
        sums_ok = torch.equal(sums.cpu(), plain)
        y = int8_ops.int8_linear(x, w, bias, torch.bfloat16)
        y_plain = int8_ops.int8_linear(x.cpu(), w.cpu(), bias.cpu(),
                                       torch.bfloat16)
        rel = ((y.cpu().float() - y_plain.float()).abs().max()
               / y_plain.float().abs().max()).item()
        ops = 2.0 * rows * K * Nout
        int8_ms = time_ms(lambda: int8_ops.int8_product(x_q, w_q))
        lin_ms = time_ms(lambda: int8_ops.int8_linear(x, w, bias,
                                                      torch.bfloat16))
        wb = w.bfloat16()
        bf16_ms = time_ms(lambda: F.linear(x, wb, bias.bfloat16()))
        bound_ms = max(ops / flops.H100_INT8_OPS,
                       (rows * K + Nout * K + 4 * rows * Nout)
                       / flops.H100_BYTES_PER_S) * 1e3
        print(f"  {name} ({rows} x {K} -> {Nout}): codes equal {codes_ok} "
              f"({x_off} activation and {w_off} weight codes differ), "
              f"int32 sums bit for bit {sums_ok}, max|card - plain| / "
              f"max|plain| {rel:.2e} (limit {INT8_RTOL:g}); _int_mm "
              f"{int8_ms:.4f} ms ({ops / int8_ms / 1e9:.1f} TOP/s, bound "
              f"{bound_ms:.4f} ms), int8_linear {lin_ms:.4f} ms, bf16 "
              f"F.linear {bf16_ms:.4f} ms [{card}]")
        if not (codes_ok and sums_ok and rel <= INT8_RTOL):
            fail(f"int8 {name}: the card's product disagrees with its plain "
                 f"version")


def int8_codes_vs_cpu(card8, cpu8, batch):
    """``card8`` (the fp32 int8 model on the card, eager attention)
    against ``cpu8`` (the same weights on the CPU, whose products are
    exact) code for code: the first layer's input from each device's
    embeddings, then each layer fed the card's input to it on both
    devices, and the codes of its output and of the inputs of its three
    products after the QKV. Returns (codes compared, codes that differ,
    the largest step, max |card - CPU| of the scores)."""
    def codes(x):
        return int8_ops.quantize_rows(x.reshape(-1, x.shape[-1]))[0].cpu()

    def record(into):
        return lambda mod, args: into.append(codes(args[0]))

    def products(layer):
        return (layer.attention_output_dense, layer.intermediate_dense,
                layer.output_dense)

    inputs, card_codes = [], []

    def keep(layer, args, out):
        inputs.append([a.cpu() if torch.is_tensor(a) else a for a in args])
        card_codes.append(codes(out))

    hooks = [card8.roberta.layer[0].register_forward_pre_hook(
        record(card_codes))]
    for layer in card8.roberta.layer:
        hooks += [d.register_forward_pre_hook(record(card_codes))
                  for d in products(layer)]
        hooks.append(layer.register_forward_hook(keep))
    cpu_codes = []
    try:
        with torch.no_grad():
            s_card = card8.scores(batch).cpu()
            torch.cuda.synchronize()
            hooks.append(cpu8.roberta.layer[0].register_forward_pre_hook(
                lambda mod, args: cpu_codes.append(codes(args[0]))))
            s_cpu = cpu8.scores({k: t.cpu() for k, t in batch.items()})
            hooks.pop().remove()
            for inp, layer in zip(inputs, cpu8.roberta.layer):
                hooks += [d.register_forward_pre_hook(record(cpu_codes))
                          for d in products(layer)]
                cpu_codes.append(codes(layer(*inp)))
    finally:
        for h in hooks:
            h.remove()
    n = off = step = 0
    for a, b in zip(card_codes, cpu_codes, strict=True):
        d = (a.int() - b.int()).abs()
        n, off = n + d.numel(), off + int((d > 0).sum())
        step = max(step, int(d.max()))
    return n, off, step, float((s_card - s_cpu).abs().max())


def int8_launches(cfg, calls, steps, counts):
    """The int8 run's launches: 12 each of #5, #6a and #6b a training
    step, and for each scored batch (int8: no fused block) #1, or #4 at
    long L, in each layer."""
    layers, n = cfg.num_hidden_layers, cfg.num_attention_heads
    want = no_launches()
    for k in TRAIN_KERNELS:
        want[k.__name__] = steps * layers
    for det, _, L in calls:
        if det:
            want["flash_attention_long" if uses_long_kernel(n, L)
                 else "flash_attention"] += layers
    print(f"  launches {({k: v for k, v in counts.items() if v})}, the "
          f"routing wants {({k: v for k, v in want.items() if v})}")
    if counts != want:
        fail("int8: the driver's launches do not match the int8 routing")


def phase_int8(card, gen):
    """int8 serving at uc2-base width: the four products against their
    plain versions, int8 against bf16 scoring from the same weights at
    B = 64 and L = 98 / 128 / 162 (#1's launches read from a
    ``uc2_torch.utils.profiling.trace``), and a short ``python -m
    uc2_torch.itm --quant int8`` run with validation and tests. Returns
    the launches of its scoring and driver runs."""
    print(f"== int8: serving products, scoring and the itm driver with "
          f"--quant int8, uc2-base at full width [{card}]")
    shutil.rmtree(INT8_DIR, ignore_errors=True)
    shutil.rmtree(ITM_DIR, ignore_errors=True)
    try:
        return _phase_int8(card, gen)
    finally:
        shutil.rmtree(INT8_DIR, ignore_errors=True)
        shutil.rmtree(ITM_DIR, ignore_errors=True)


def _phase_int8(card, gen):
    int8_product_checks(gen, card)
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention=True)
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    q8 = model.serving("int8")
    ref32 = UC2ForImageTextRetrieval(
        cfg.replace(use_pallas_attention=False, dtype="float32"),
        device="cuda")
    ref32.load_state_dict(model.state_dict())
    # the int8 function through the eager attention chain: #1's plain
    # version on the card, the same int8 products
    eager8 = UC2ForImageTextRetrieval(cfg.replace(use_pallas_attention=False,
                                                  quant="int8"),
                                      device="cuda")
    eager8.load_state_dict(model.state_dict())
    # the int8 function in fp32 on the card and on the CPU, code for code
    cfg8 = cfg.replace(use_pallas_attention=False, dtype="float32",
                       quant="int8")
    card8 = UC2ForImageTextRetrieval(cfg8, device="cuda")
    card8.load_state_dict(model.state_dict())
    cpu8 = UC2ForImageTextRetrieval(cfg8, device="cpu")
    cpu8.load_state_dict(model.state_dict())
    # the rank readings' other weight draws
    others = [UC2ForImageTextRetrieval(cfg, device="cuda", seed=seed)
              for seed in INT8_SEEDS[1:]]
    txt_db, img_db = synth_gallery(seed=0, n_imgs=N_IMGS, txt_per_img=1,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    edges = retrieval.bucket_edges(TXT_LEN, NUM_BB)
    bucket_of = np.searchsorted(edges, [img_db.name2nbb[i]
                                        for i in sorted(img_db.name2nbb)])
    names = sorted(img_db.name2nbb)
    total = no_launches()
    layers = cfg.num_hidden_layers
    for bi, nb in enumerate(edges):
        L = TXT_LEN + nb
        ids_b = [im for im, bk in zip(names, bucket_of) if bk == bi]
        batch, n = bucket_batch(img_db, ids_b, txt_db, txt_db.ids[0], nb)
        s_bf = model.scores(batch)[:n].float().cpu().numpy()
        s_32 = ref32.scores(batch)[:n].cpu().numpy()
        reset_launches()
        int8_ops.int8_product.launches = 0
        s_q8 = q8.scores(batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, c in counts.items():
            total[k] += c
        prods = int8_ops.int8_product.launches
        s_q8 = s_q8[:n].float().cpu().numpy()
        s_e8 = eager8.scores(batch)[:n].float().cpu().numpy()
        d_e8 = float(np.abs(s_q8 - s_e8).max())
        want = no_launches()
        want["flash_attention"] = layers
        rho = spearman(s_bf, s_q8)
        diff = float(np.abs(s_q8 - s_bf).max())
        print(f"  L={L}: int8 scores finite {bool(np.isfinite(s_q8).all())}"
              f", max|int8 - bf16| {diff:.4e} (bf16 spread "
              f"{float(s_bf.max() - s_bf.min()):.4e}), rank correlation "
              f"{rho:.4f} (bf16 / eager fp32 "
              f"{spearman(s_bf, s_32):.4f}, int8 / eager fp32 "
              f"{spearman(s_q8, s_32):.4f}) over {n} images; |int8 kernel "
              f"path - int8 eager path| {d_e8:.4e} (tolerance {SCORE_TOL}); "
              f"launches "
              f"{({k: v for k, v in counts.items() if v})}, int8 products "
              f"{prods} (want {4 * layers})")
        t0 = time.perf_counter()
        n_codes, off, step, d_cpu = int8_codes_vs_cpu(
            card8, cpu8, {k: t[:INT8_CPU_ROWS] for k, t in batch.items()})
        print(f"  L={L}: the int8 function in fp32, card against CPU code "
              f"for code over {INT8_CPU_ROWS} pairs (each layer fed the "
              f"card's input): {off} of "
              f"{n_codes} codes differ ({off / n_codes:.2e}, limit "
              f"{INT8_CODE_SHARE:g}), by at most {step} step; scores after "
              f"{layers} layers {d_cpu:.4e} apart "
              f"({time.perf_counter() - t0:.1f} s)")
        if off > INT8_CODE_SHARE * n_codes or step > 1:
            fail(f"int8 at L={L}: the card's codes differ from the CPU's "
                 f"({off} of {n_codes}, up to {step} steps)")
        rhos = []
        for seed, m in zip(INT8_SEEDS, [model] + others):
            m8 = m.serving("int8")
            for t in range(INT8_TEXTS):
                bt = (batch if t == 0 else
                      bucket_batch(img_db, ids_b, txt_db, txt_db.ids[t],
                                   nb)[0])
                rhos.append(spearman(m.scores(bt)[:n].float().cpu().numpy(),
                                     m8.scores(bt)[:n].float().cpu().numpy()))
        print(f"  L={L}: rank correlation int8 / bf16 over "
              f"{INT8_TEXTS} texts x {len(INT8_SEEDS)} weight draws: lowest "
              f"{min(rhos):.4f}, mean {np.mean(rhos):.4f}, highest "
              f"{max(rhos):.4f} (limit {INT8_RANK_RHO} on each): "
              + ", ".join(f"{r:.4f}" for r in rhos))
        if not np.isfinite(s_q8).all() or min(rhos) < INT8_RANK_RHO:
            fail(f"int8 scores at L={L}: not finite, or rank correlation "
                 f"{min(rhos):.4f} < {INT8_RANK_RHO}")
        if d_e8 > SCORE_TOL:
            fail(f"int8 scores at L={L}: the kernel path is {d_e8:.4e} from "
                 f"the eager path")
        if counts != want or prods != 4 * layers:
            fail(f"int8 scoring at L={L} launched "
                 f"{({k: v for k, v in counts.items() if v})} and {prods} "
                 f"int8 products: not #1 and four products in each layer")
        ms_q8 = time_ms(lambda: q8.scores(batch), iters=10)
        ms_bf = time_ms(lambda: model.scores(batch), iters=10)
        ms_q8b = time_ms(lambda: q8.scores(batch), iters=10)
        tf = flops.encoder_fwd_flops_per_pair(L) * B
        print(f"  L={L} B={B}: int8 {ms_q8:.3f}, {ms_q8b:.3f} ms/batch, "
              f"bf16 {ms_bf:.3f} ms/batch (int8 / bf16 "
              f"{min(ms_q8, ms_q8b) / ms_bf:.2f}); implied "
              f"{tf / min(ms_q8, ms_q8b) / 1e9:.1f} / {tf / ms_bf / 1e9:.1f}"
              f" TFLOP/s of the encoder's products [{card}]")
        if L == 98:
            reset_launches()
            with profiling.trace(os.path.join(INT8_DIR, "trace")) as prof:
                q8.scores(batch)
            dev = sorted(device_rows(prof), reverse=True)
            attn = sum(c for _, c, key in dev if "attn_stream" in key)
            busy = sum(ms for ms, _, _ in dev)
            print(f"  traced int8 batch at L={L}: #1's kernel launched "
                  f"{attn} times on the device (wrapper count "
                  f"{flash_attention.launches}), device busy {busy:.3f} ms; "
                  f"top kernels: " + "; ".join(
                      f"{ms:.3f} ms {c}x {key[:60]}"
                      for ms, c, key in dev[:5]))
            total["flash_attention"] += flash_attention.launches
            if attn != layers or flash_attention.launches != layers:
                fail(f"int8: the trace shows {attn} launches of #1, not "
                     f"{layers}")
    del model, q8, ref32, eager8, card8, cpu8, others
    torch.cuda.empty_cache()

    # the itm driver at --quant int8: 2 steps, validation after each, the
    # tests at the end, all scored under int8
    t0 = time.perf_counter()
    stores = itm_stores()
    with open(ITM_CONFIG) as f:
        ic = json.load(f)
    icfg = set_dropout(UC2Config.from_json_file(ic["model_config"]).replace(
        dtype=ic["dtype"]), ic["dropout"])
    ckpt = os.path.join(ITM_DIR, "init.pt")
    init = UC2ForImageTextRetrieval(icfg, device="cuda", seed=0)
    torch.save({k: v.cpu() for k, v in init.state_dict().items()}, ckpt)
    del init
    out = os.path.join(ITM_DIR, "int8")
    calls = []
    reset_launches()
    int8_ops.int8_product.launches = 0
    with recorded_scores(calls):
        run = run_itm(itm_argv(out, stores, ckpt, "--quant", "int8",
                               "--num_train_steps", str(INT8_STEPS),
                               "--valid_steps", "1", "--save_steps", "100",
                               "--gradient_accumulation_steps", "1",
                               "--eval_batch_size", str(B)))
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, c in counts.items():
        total[k] += c
    print(f"  python -m uc2_torch.itm --quant int8 (stores of phase 16; cuts:"
          f" --num_train_steps {INT8_STEPS} --valid_steps 1 "
          f"--gradient_accumulation_steps 1 --eval_batch_size {B}) in "
          f"{time.perf_counter() - t0:.1f} s with the stores; int8 products "
          f"{int8_ops.int8_product.launches}")
    itm_run_report("--quant int8", run, card, set(range(INT8_STEPS + 1)))
    int8_launches(icfg, calls, INT8_STEPS, counts)
    scored = sum(1 for det, _, _ in calls if det)
    if int8_ops.int8_product.launches != 4 * icfg.num_hidden_layers * scored:
        fail(f"int8 driver: {int8_ops.int8_product.launches} int8 products "
             f"for {scored} scored batches")
    if (run.step != INT8_STEPS or len(run.val) != INT8_STEPS
            or set(run.results) != {"coco_en_test", "coco_zh_test"}):
        fail(f"int8 driver: step {run.step}, {len(run.val)} validations, "
             f"tests {sorted(run.results)}")
    with open(os.path.join(out, "test_results.json")) as f:
        if json.load(f) != run.results:
            fail("int8 driver: test_results.json is not the run's results")
    return total


# ------------------------------------------------------------- runbook
RUNBOOK_DIR = os.path.join("build", "runbook_smoke")
RUNBOOK_NUM_BB = 100      # the second run's regions: buckets L = 98, 128, 162
# the runbook's parity gate, tighter than SCORE_TOL: on the H100 the
# parity batch's scores spread by a std of 8.4e-2 over its 8 pairs, and
# the bf16 kernels came within 5.4e-3 of the fp32 oracle
RUNBOOK_PARITY_TOL = 2e-2
RESULT_COLLATE = re.compile(
    r"^RESULT collate fp16=[01] mrfr_targets=[01]: (\d+) ex/s$")


def runbook_checkpoint(path):
    """A uc2-base checkpoint under the original UC2 key names: the port's
    seed-0 retrieval model, every parameter plus 0.02 N(0, 1) from
    ``torch.manual_seed(0)`` (as the runbook's CPU test perturbs its
    oracle), written without ``rank_output`` so that the runbook takes the
    ITM head's. Returns the leaves the runbook should load: the model's
    but the rank head's."""
    cfg = UC2Config.from_json_file("config/uc2-base.json")
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.02)
    tree = convert.params_to_jax(model.state_dict())
    want = (verify_real_ckpt.count_leaves(tree)
            - verify_real_ckpt.count_leaves(tree["rank_output"]))
    sd = convert.params_to_uc2_state_dict(model.state_dict())
    del model, tree
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items() if not k.startswith("rank_output")},
               path)
    return want


def runbook_batches(txt_dir, img_dir, num_bb):
    """{joint L: scored batches} of one full eval over the stores."""
    img = db.DetectFeatDb(img_dir, num_bb=num_bb)
    edges, _, batches = bucket_batches(len(db.TxtTokDb(txt_dir).ids),
                                       list(img.name2nbb.values()), num_bb)
    return {TXT_LEN + e: n for e, n in zip(edges, batches) if n}


def run_runbook(what, argv, cfg, card):
    """``uc2_torch.verify_real_ckpt.main(argv)`` in this process, its
    output echoed: (report, output, launches, scores calls, the first
    scored batch's scores)."""
    calls, evals, scores = [], [], []
    buf = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with (recorded_scores(calls, evals, scores),
          contextlib.redirect_stdout(buf)):
        report = verify_real_ckpt.main(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line[:300]}")
    print(f"  {what}: {time.perf_counter() - t0:.1f} s; " + "; ".join(
        f"eval {q}: {n} batches in {s:.2f} s = {s / n * 1e3:.2f} ms/batch"
        for q, s, n in evals) + f" [{card}]")
    want = no_launches()
    layers = cfg.num_hidden_layers
    for _, quant, L in calls:
        if quant == "int8":
            want["flash_attention_long" if uses_long_kernel(
                cfg.num_attention_heads, L) else "flash_attention"] += layers
        else:
            for k, n in gate_launches(cfg, L).items():
                want[k] += n
    print(f"  {what}: launches {({k: v for k, v in counts.items() if v})}, "
          f"the routing wants {({k: v for k, v in want.items() if v})}")
    if counts != want:
        fail(f"runbook {what}: the launches do not match the routing")
    return report, out, counts, calls, scores[0].float().cpu().numpy()


def check_rk(what, metrics):
    vals = list(metrics.values())
    ok = bool(vals) and all(np.isfinite(v) and 0 <= v <= 100 for v in vals)
    print(f"  {what} R@K {json.dumps(metrics)} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"runbook: {what} R@K not finite in [0, 100]: {metrics}")


def phase_runbook(card):
    """The real-checkpoint runbook ``python -m uc2_torch.verify_real_ckpt``
    at uc2-base width on the demo corpus (``uc2_torch.make_demo_data``)
    re-encoded in the release's LMDB format, from a checkpoint in the
    release's key names without a rank head; then ``python -m
    uc2_torch.collate_bench``. Returns the runbook runs' launches."""
    print(f"== runbook: python -m uc2_torch.verify_real_ckpt on the demo "
          f"corpus in the release's LMDB format, uc2-base at full width; "
          f"python -m uc2_torch.collate_bench [{card}]")
    shutil.rmtree(RUNBOOK_DIR, ignore_errors=True)
    try:
        return _phase_runbook(card)
    finally:
        shutil.rmtree(RUNBOOK_DIR, ignore_errors=True)


def _phase_runbook(card):
    cfg = UC2Config.from_json_file("config/uc2-base.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        demo = make_demo_data.main(os.path.join(RUNBOOK_DIR, "demo"))
    t1 = time.perf_counter()
    lmdb = reference_lmdb(demo["en"]["txt_db"], demo["en"]["img_db"],
                          os.path.join(RUNBOOK_DIR, "lmdb"))
    t2 = time.perf_counter()
    ckpt = os.path.join(RUNBOOK_DIR, "uc2_base_norank.pt")
    want_leaves = runbook_checkpoint(ckpt)
    t3 = time.perf_counter()
    print(f"  demo corpus (64 images x 2 captions, 2048-d, 10-100 boxes) "
          f"{t1 - t0:.1f} s; its en stores in the release's LMDB format "
          f"{t2 - t1:.1f} s; the checkpoint "
          f"({os.path.getsize(ckpt) / 2 ** 30:.2f} GiB, no rank_output) "
          f"{t3 - t2:.1f} s")
    total = no_launches()

    # 1: the defaults (num_bb 36: L = 80, 98) with --quant int8, from LMDB
    work = os.path.join(RUNBOOK_DIR, "work")
    report, out, counts, calls, first = run_runbook(
        "run 1 (LMDB, num_bb 36, --quant int8)",
        ["--checkpoint", ckpt, "--txt_db", lmdb["txt_db"],
         "--img_db", lmdb["img_db"], "--workdir", work, "--quant", "int8"],
        cfg, card)
    for k, c in counts.items():
        total[k] += c
    txt_dir, img_dir = (os.path.join(work, "txt_db"),
                        os.path.join(work, "img_db"))
    diff = report.get("logit_max_abs_diff", float("inf"))
    print(f"  parity batch (8 x L = {TXT_LEN + 36}, the port bf16 with its "
          f"kernels, the oracle fp32 on the CPU): scores' std "
          f"{first.std():.4e} (range {first.min():.4f}..{first.max():.4f}),"
          f" max|d| {diff:.4e} (tolerance {RUNBOOK_PARITY_TOL}), mean|d| "
          f"{report.get('logit_mean_abs_diff', float('nan')):.4e}, pearson "
          f"{report.get('logit_pearson', float('nan')):.6f} (not gated); "
          f"oracle missing {len(report.get('oracle_missing_keys', []))} "
          f"keys, unexpected {len(report.get('oracle_unexpected_keys', []))}"
          f"; n_loaded_params {report['n_loaded_params']} (want "
          f"{want_leaves})")
    if not diff <= RUNBOOK_PARITY_TOL:
        fail(f"runbook: logit parity {diff:.4e} > {RUNBOOK_PARITY_TOL}")
    if report["n_loaded_params"] != want_leaves:
        fail(f"runbook: {report['n_loaded_params']} loaded leaves, not "
             f"{want_leaves}")
    if "[verify] rank head initialized from pretrained ITM head" not in out:
        fail("runbook: the rank head was not taken from the ITM head")
    if not (os.path.exists(os.path.join(txt_dir, "txt.u2s"))
            and os.path.exists(os.path.join(img_dir, "feat.u2s"))):
        fail("runbook: the LMDB databases were not imported")
    check_rk("run 1 bf16", report["retrieval"])
    check_rk("run 1 int8", report.get("retrieval_int8", {}))
    print(f"  run 1 int8 R@K delta "
          f"{json.dumps(report.get('retrieval_int8_delta'))}")
    want_batches = runbook_batches(txt_dir, img_dir, 36)
    got = {q: {} for q in ("none", "int8")}
    for _, q, L in calls:
        got[q][L] = got[q].get(L, 0) + 1
    parity = {TXT_LEN + 36: 1}
    print(f"  run 1 scored batches: bf16 {got['none']} (the parity batch "
          f"{parity} and the buckets' {want_batches}), int8 {got['int8']}")
    bf16_want = dict(want_batches)
    for L, n in parity.items():
        bf16_want[L] = bf16_want.get(L, 0) + n
    if got["none"] != bf16_want or got["int8"] != want_batches:
        fail("runbook: run 1 did not score the buckets' batches")

    # 2: --num_bb 100 (L = 98, 128, 162) from the imported u2s stores
    report2, _, counts, calls, _ = run_runbook(
        f"run 2 (u2s, num_bb {RUNBOOK_NUM_BB}, --skip_torch)",
        ["--checkpoint", ckpt, "--txt_db", txt_dir, "--img_db", img_dir,
         "--workdir", os.path.join(RUNBOOK_DIR, "work2"),
         "--num_bb", str(RUNBOOK_NUM_BB), "--skip_torch"], cfg, card)
    for k, c in counts.items():
        total[k] += c
    check_rk("run 2 bf16", report2["retrieval"])
    want2 = runbook_batches(txt_dir, img_dir, RUNBOOK_NUM_BB)
    got2 = {}
    for _, _, L in calls:
        got2[L] = got2.get(L, 0) + 1
    print(f"  run 2 scored batches {got2} (the buckets' {want2}); edges "
          f"{retrieval.default_nbb_buckets(TXT_LEN, RUNBOOK_NUM_BB)}")
    if got2 != want2 or "logit_max_abs_diff" in report2:
        fail("runbook: run 2 did not score the buckets' batches alone")
    os.remove(ckpt)

    # collate_bench: host work only
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        collate_bench.main(["--seconds", "0.5"])
    lines = buf.getvalue().splitlines()
    rates = [RESULT_COLLATE.match(x) for x in lines]
    for x in lines:
        print(f"    | {x}")
    if len(lines) != 4 or not all(m and int(m.group(1)) > 0 for m in rates):
        fail(f"collate_bench: {lines}")
    return total


# ------------------------------------------------------------- remat
REMAT_B, REMAT_NB = 128, 100      # the mlm step at (128, 162)
REMAT_SEED = 99
IMPORT_DIR = os.path.join("build", "import_smoke")
IMPORT_IMGS = 64


def remat_grads(model, batch, seed):
    """(loss, {name: gradient}, the rng's state after) of one mlm forward
    and backward."""
    model.zero_grad(set_to_none=True)
    rng = DropoutRng(seed, "cuda")
    loss, _ = make_loss_fn("mlm")(model, batch, rng)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads, rng.get_state()


def phase_remat(card):
    """The mlm step at (128, 162) under "pallas-train" at dropout 0.1 with
    remat none / full / dots, without and with the training FFN kernels
    (UC2_FFN_TRAIN=1): loss and gradients of full and dots bit for bit
    none's, the rng streams where none leaves them, launches (the
    recompute runs #5, and #9, again), ms/step, peak memory and implied
    TFLOP/s; then the LMDB importer on a fixture in the original
    release's format and two mlm steps from the imported stores. Returns
    the launches of its steps."""
    print(f"== remat: the mlm step at ({REMAT_B}, {TRAIN_TXT + REMAT_NB}) "
          f"under remat none / full / dots, then the LMDB importer [{card}]")
    shutil.rmtree(IMPORT_DIR, ignore_errors=True)
    with env_set("UC2_FFN_TRAIN", None):
        try:
            return _phase_remat(card)
        finally:
            shutil.rmtree(IMPORT_DIR, ignore_errors=True)


def _phase_remat(card):
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16", use_pallas_attention="pallas-train")
    txt_db, img_db = synth_gallery(seed=1, n_imgs=N_IMGS, txt_per_img=2,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    batches, _ = mlm_batches(txt_db, img_db, 66, REMAT_NB, REMAT_B, 3,
                             seed=REMAT_SEED)
    L = TRAIN_TXT + REMAT_NB
    layers = cfg.num_hidden_layers
    work = flops.grad_flops_per_example(TRAIN_TXT, REMAT_NB, TRAIN_SLOTS)
    total = no_launches()
    start = None
    for ffn in (False, True):
        with env_set("UC2_FFN_TRAIN", "1" if ffn else None):
            want0 = None
            for remat in ("none", "full", "dots"):
                model = UC2ForPretraining(cfg.replace(remat=remat),
                                          device="cuda", seed=0)
                if start is None:
                    start = {k: v.clone()
                             for k, v in model.state_dict().items()}
                model.load_state_dict(start)
                reset_launches()
                got = remat_grads(model, batches[0], REMAT_SEED)
                torch.cuda.synchronize()
                counts = launch_counts()
                for k, c in counts.items():
                    total[k] += c
                rec = 2 if remat != "none" else 1
                want = no_launches()
                want.update({k.__name__: layers for k in TRAIN_KERNELS})
                want["flash_attention_train_fwd"] = rec * layers
                if ffn:
                    want["fused_ffn_block_train_fwd"] = rec * layers
                    want["fused_ffn_block_train_bwd"] = layers
                tag = f"{'FFN kernels, ' if ffn else ''}remat {remat}"
                if counts != want:
                    fail(f"remat: {tag} launched "
                         f"{({k: v for k, v in counts.items() if v})}, not "
                         f"{({k: v for k, v in want.items() if v})}")
                if want0 is None:
                    want0 = got
                    same = "(the reference run)"
                else:
                    diff = [k for k in want0[1]
                            if not torch.equal(got[1][k], want0[1][k])]
                    rng_ok = all(torch.equal(a, b)
                                 for a, b in zip(got[2], want0[2]))
                    same = (f"loss bit for bit {torch.equal(got[0], want0[0])}"
                            f", {len(want0[1]) - len(diff)} of "
                            f"{len(want0[1])} gradients bit for bit, rng "
                            f"streams equal {rng_ok}")
                    if (diff or not rng_ok or not torch.equal(got[0],
                                                              want0[0])
                            or set(got[1]) != set(want0[1])):
                        fail(f"remat: {tag} differs from remat none "
                             f"({diff[:4]})")
                del got
                opt = pretrain_optimizer(model)
                rng = DropoutRng(REMAT_SEED, "cuda")
                train_step(model, opt, batches[1], rng)       # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                for batch in batches:
                    t1 = time.perf_counter()
                    m = train_step(model, opt, batch, rng)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t1) * 1e3)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ms = float(np.median(times))
                print(f"  {tag}: {same}; {ms:.2f} ms/step median "
                      f"({', '.join(f'{t:.2f}' for t in times)}), peak "
                      f"memory {peak:.2f} GiB, implied "
                      f"{work * REMAT_B / ms / 1e9:.1f} TFLOP/s (the model's"
                      f" products, recompute not counted), loss "
                      f"{m['loss'].item():.4f} [{card}]")
                if not np.isfinite(m["loss"].item()):
                    fail(f"remat: {tag} gave a non-finite loss")
                del model, opt
                torch.cuda.empty_cache()

    # the LMDB importer on a fixture in the original release's format,
    # then two mlm steps on the card from the imported stores
    t0 = time.perf_counter()
    corpus = synth_corpus(os.path.join(IMPORT_DIR, "u2s"),
                          n_imgs=IMPORT_IMGS, txt_per_img=2, seed=5)
    fixture = reference_lmdb(corpus["txt_db"], corpus["img_db"],
                             os.path.join(IMPORT_DIR, "lmdb"))
    t1 = time.perf_counter()
    n_txt = import_lmdb.import_txt(fixture["txt_db"],
                                   os.path.join(IMPORT_DIR, "txt_db"))
    n_img = import_lmdb.import_img(fixture["img_db"],
                                   os.path.join(IMPORT_DIR, "img_db"),
                                   npz=True)
    t2 = time.perf_counter()
    txt, img = (db.TxtTokDb(os.path.join(IMPORT_DIR, "txt_db")),
                db.DetectFeatDb(os.path.join(IMPORT_DIR, "img_db")))
    same = all(np.array_equal(img[f][0], db.DetectFeatDb(corpus["img_db"])[
        f][0]) for f in list(img.name2nbb)[:8])
    loader = TaskLoader("mlm", datasets.MlmDataset(txt, img),
                        [BucketSpec(TRAIN_TXT, REMAT_NB, 32, TRAIN_SLOTS)],
                        seed=0)
    put = task_batch_to_device("cuda")
    model = UC2ForPretraining(cfg, device="cuda", seed=0)
    opt = pretrain_optimizer(model)
    reset_launches()
    losses = []
    for i in range(2):
        _, batch = put(("mlm", loader.next_batch()))
        losses.append(train_step(model, opt, batch,
                                 DropoutRng(i, "cuda"))["loss"].item())
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, c in counts.items():
        total[k] += c
    print(f"  importer: fixture of {IMPORT_IMGS} images x 2 captions "
          f"(2048-d, vocab 250002) written in {t1 - t0:.1f} s; imported "
          f"{n_txt} text records and {n_img} images in {t2 - t1:.2f} s; "
          f"features equal the corpus's {same}; two mlm steps from the "
          f"imported stores: losses {[round(x, 4) for x in losses]}, "
          f"launches {({k: v for k, v in counts.items() if v})}")
    if not (same and all(np.isfinite(losses))
            and counts["flash_attention_train_fwd"] == 2 * layers):
        fail("import: the imported stores or their steps are wrong")
    return total


TP_ROWS = {
    "fused_attn_block_partial": dict(
        name="fused_attn_block_partial", route="cuda",
        source="uc2_torch/csrc/fused_attn_block.cu",
        replaces="uc2_tpu/ops/fused_block.py:37"),
    "fused_ffn_block_partial": dict(
        name="fused_ffn_block_partial", route="cuda",
        source="uc2_torch/csrc/fused_ffn_block.cu",
        replaces="uc2_tpu/ops/fused_block.py:251"),
    "fused_attn_block_v2_partial": dict(
        name="fused_attn_block_v2_partial", route="cuda",
        source="uc2_torch/csrc/fused_attn_block_v2.cu",
        replaces="uc2_tpu/ops/fused_block.py:138"),
    "fused_ffn_block_train_partial_fwd": dict(
        name="fused_ffn_block_train_partial_fwd", route="cuda",
        source="uc2_torch/csrc/fused_ffn_block.cu",
        replaces="uc2_tpu/ops/ffn_train.py:68"),
    "fused_ffn_block_train_partial_bwd": dict(
        name="fused_ffn_block_train_partial_bwd", route="cuda",
        source="uc2_torch/csrc/ffn_train_bwd.cu",
        replaces="uc2_tpu/ops/ffn_train.py:90"),
}
TP_BLOCK_SHAPES = ((B, 128), (B, 162), (32, 262))
TP_EDGES = ((1, 1), (2, 65), (3, 129), (2, 512), (67, 128))
TP_TRAIN_SHAPES = ((128, 162), (16, 512))


def partial_attn_bytes_flops(b, L, n):
    """#2's partial mode: q, k, v and the bias read, Wo's n * 64 columns,
    the fp32 partial written; attention over n heads and the
    out-projection over their n * 64 inputs."""
    return (3 * b * L * n * D * 2 + b * L * 4 + H * n * D * 2
            + b * L * H * 4, 4 * b * n * L * L * D + 2 * b * L * n * D * H)


def partial_ffn_bytes_flops(rows, Fl):
    """#3's partial mode: x, the shard's W1, b1 and W2 read, the fp32
    partial written; its two products."""
    return (rows * H * 2 + 2 * Fl * H * 2 + Fl * 4 + rows * H * 4,
            4 * rows * H * Fl)


def tp_partial_checks(gen):
    """#2's and #3's partial modes on each shard of T = 2 and 4 against
    their plain versions, repeated bit for bit, timed beside the whole
    kernel; the partials summed over the shards with the epilogue against
    the whole kernel. Returns the JSON rows."""
    rows = {k: dict(v) for k, v in TP_ROWS.items()}
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)
    for b, L in TP_BLOCK_SHAPES:
        q, k, v, bias = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        whole = (q, k, v, bias, x, wo, bo, gamma, beta)
        full_ms = time_ms(lambda: fused_attn_block(*whole))
        for T in (2, 4):
            n = N // T
            parts = []
            for m in range(T):
                sl = slice(m * n, (m + 1) * n)
                args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], bias,
                        wo[:, m * n * D:(m + 1) * n * D].contiguous())
                if m == 0:
                    run_case(rows, "fused_attn_block_partial", b, L,
                             fused_attn_block_partial,
                             fused_attn_block_partial_plain, args,
                             *partial_attn_bytes_flops(b, L, n),
                             report=(T, b, L) == (2, B, 162),
                             graph=(T, L) == (2, 162))
                    part_ms = time_ms(lambda: fused_attn_block_partial(*args))
                    print(f"    #2 whole (12 heads) on the same input: "
                          f"{full_ms:.4f} ms; partial n = {n} / whole "
                          f"{part_ms / full_ms:.2f}")
                out = fused_attn_block_partial(*args)
                if m == T - 1:
                    repeat_bitwise(f"#2 partial T={T} shard {m} B={b} L={L}",
                                   lambda: fused_attn_block_partial(*args),
                                   out)
                parts.append(out)
            got = block_epilogue(sum(parts), bo, x, gamma, beta)
            compare(f"#2 partials of T={T} summed + epilogue vs #2 whole "
                    f"B={b} L={L}", got, fused_attn_block(*whole))
    # the edges of the query tiles (and one grid past a wave), on the last
    # shard of T = 2 and 4, each call repeated bit for bit
    for b, L in TP_EDGES:
        q, k, v, bias = heads(gen, b, L)
        for T in (2, 4):
            n = N // T
            sl = slice(N - n, N)
            args = (q[:, :, sl], k[:, :, sl], v[:, :, sl], bias,
                    wo[:, (N - n) * D:].contiguous())
            out = fused_attn_block_partial(*args)
            err = compare(f"fused_attn_block_partial T={T} B={b} L={L}",
                          out, fused_attn_block_partial_plain(*args))
            row = rows["fused_attn_block_partial"]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            repeat_bitwise(f"#2 partial T={T} B={b} L={L}",
                           lambda: fused_attn_block_partial(*args), out,
                           times=REPEATS_PAST_A_WAVE if b > 3 else 1)
    for Fl in (FF // 2, FF // 4):
        T = FF // Fl
        w1 = (torch.randn(FF, H, generator=gen, device="cuda")
              * 0.05).bfloat16()
        w2 = (torch.randn(H, FF, generator=gen, device="cuda")
              * 0.05).bfloat16()
        b1, b2 = vec(gen, FF, 0.02), vec(gen, H, 0.02)
        for L in (98, 128, 162):
            x = torch.randn(B, L, H, generator=gen, device="cuda").bfloat16()
            whole = (x, w1, b1, w2, b2, gamma, beta)
            full_ms = time_ms(lambda: fused_ffn_block(*whole))
            parts = []
            for m in range(T):
                sl = slice(m * Fl, (m + 1) * Fl)
                args = (x, w1[sl].contiguous(), b1[sl].contiguous(),
                        w2[:, sl].contiguous())
                if m == 0:
                    run_case(rows, "fused_ffn_block_partial", B, L,
                             fused_ffn_block_partial,
                             fused_ffn_block_partial_plain, args,
                             *partial_ffn_bytes_flops(B * L, Fl),
                             report=(Fl, L) == (FF // 2, 162),
                             graph=(Fl, L) == (FF // 2, 162))
                    part_ms = time_ms(lambda: fused_ffn_block_partial(*args))
                    print(f"    #3 whole (F = {FF}) on the same rows: "
                          f"{full_ms:.4f} ms; partial F = {Fl} / whole "
                          f"{part_ms / full_ms:.2f}")
                out = fused_ffn_block_partial(*args)
                if m == T - 1:
                    repeat_bitwise(f"#3 partial F={Fl} shard {m} L={L}",
                                   lambda: fused_ffn_block_partial(*args),
                                   out)
                parts.append(out)
            got = block_epilogue(sum(parts), b2, x, gamma, beta)
            compare(f"#3 partials of F={Fl} summed + epilogue vs #3 whole "
                    f"L={L}", got, fused_ffn_block(*whole))
    return rows


def partial_v2_bytes_flops(b, L, n):
    """#7's partial mode: x, the shard's W_qkv rows, b_qkv and Wo columns
    and the bias read, the fp32 partial written; the shard's projection,
    its attention over n heads and the out-projection of its n * 64
    inputs."""
    nd = n * D
    return (b * L * H * 2 + 3 * nd * H * 2 + 3 * nd * 4 + b * L * 4
            + H * nd * 2 + b * L * H * 4,
            2 * b * L * H * 3 * nd + 4 * b * n * L * L * D
            + 2 * b * L * nd * H)


def partial_ffn_train_bytes_flops(rows, Fl, backward):
    """#9's partial mode (x, W1, b1, W2, b2 read, the fp32 partial
    written; two products) or #10's (x, W1, b1, W2 and the fp32 dy_pre
    read; dx, dW1, db1, dW2, db2 written; five products)."""
    if not backward:
        return (rows * H * 2 + 2 * Fl * H * 2 + Fl * 4 + H * 4
                + rows * H * 4, 4 * rows * H * Fl)
    return (rows * H * 2 + 2 * Fl * H * 2 + Fl * 4 + rows * H * 4
            + rows * H * 2 + 2 * Fl * H * 4 + Fl * 4 + H * 4,
            10 * rows * H * Fl)


# #9 and #10 in their partial modes: the mix bucket's rows (128 x 162) and
# the TP step's (32 x 162); F / T = 1536 and 768
TP_FFN_ROWS = (128 * 162, 32 * 162)
# the int8 row-parallel product: the rows of a scored batch at (64, 98)
TP_INT8_ROWS = B * 98


def tp_route_checks(gen, rows):
    """The partial modes of #7 (each shard of T = 2 and 4 of the heads),
    #9 and #10 (each shard of F / T = 1536 and 768, rates 0.1 and 0)
    against their plain versions, repeated bit for bit, timed beside the
    whole kernel on the same input, and summed over the shards against
    the whole kernel; the int8 row-parallel product's codes and int32
    sums on T = 2 and 4 shards, from the group's maxima, bit for bit the
    whole product's. Fills ``rows``."""
    wq = (torch.randn(3 * H, H, generator=gen, device="cuda")
          * 0.05).bfloat16()
    bq = vec(gen, 3 * H, 0.05)
    wo = (torch.randn(H, H, generator=gen, device="cuda") * 0.05).bfloat16()
    bo, gamma, beta = vec(gen, H, 0.02), vec(gen, H, 0.1, 1.0), vec(gen, H, 0.1)
    name = "fused_attn_block_v2_partial"
    for b, L in TP_BLOCK_SHAPES:
        _, _, _, bias = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        whole = (x, wq, bq, bias, wo, bo, gamma, beta, N)
        full = fused_attn_block_v2(*whole)
        full_ms = time_ms(lambda: fused_attn_block_v2(*whole))
        for T in (2, 4):
            n = N // T
            parts = []
            for m in range(T):
                args = (x, shard_tensor(wq, "qkv", m, T),
                        shard_tensor(bq, "qkv", m, T), bias,
                        wo[:, m * n * D:(m + 1) * n * D].contiguous(), n)
                out = fused_attn_block_v2_partial(*args)
                if m == 0:
                    run_case(rows, name, b, L, fused_attn_block_v2_partial,
                             fused_attn_block_v2_partial_plain, args,
                             *partial_v2_bytes_flops(b, L, n),
                             report=(T, b, L) == (2, B, 162),
                             graph=(T, L) == (2, 162))
                    part_ms = time_ms(
                        lambda: fused_attn_block_v2_partial(*args))
                    print(f"    #7 whole (12 heads) on the same input: "
                          f"{full_ms:.4f} ms; partial n = {n} / whole "
                          f"{part_ms / full_ms:.2f}")
                else:
                    err = compare(f"{name} T={T} shard {m} B={b} L={L}", out,
                                  fused_attn_block_v2_partial_plain(*args))
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"], err)
                if m == T - 1:
                    repeat_bitwise(f"#7 partial T={T} shard {m} B={b} L={L}",
                                   lambda: fused_attn_block_v2_partial(*args),
                                   out)
                parts.append(out)
            compare(f"#7 partials of T={T} summed + epilogue vs #7 whole "
                    f"B={b} L={L}",
                    block_epilogue(sum(parts), bo, x, gamma, beta), full)
    for b, L in TP_EDGES:
        _, _, _, bias = heads(gen, b, L)
        x = torch.randn(b, L, H, generator=gen, device="cuda").bfloat16()
        for T in (2, 4):
            n = N // T
            args = (x, shard_tensor(wq, "qkv", T - 1, T),
                    shard_tensor(bq, "qkv", T - 1, T), bias,
                    wo[:, (N - n) * D:].contiguous(), n)
            out = fused_attn_block_v2_partial(*args)
            err = compare(f"{name} T={T} B={b} L={L}", out,
                          fused_attn_block_v2_partial_plain(*args))
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            repeat_bitwise(f"#7 partial T={T} B={b} L={L}",
                           lambda: fused_attn_block_v2_partial(*args), out,
                           times=REPEATS_PAST_A_WAVE if b > 3 else 1)

    w1, b1, w2, b2, g2, be2 = ffn_weights(gen)
    fwd, bwd = ("fused_ffn_block_train_partial_fwd",
                "fused_ffn_block_train_partial_bwd")
    for R in TP_FFN_ROWS:
        x = torch.randn(R, H, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(R, H, generator=gen, device="cuda").bfloat16()
        for rate in (0.1, 0.0):
            seed = FFN_SEED + R
            wargs = (x, w1, b1, w2, b2, g2, be2, seed, rate)
            full = fused_ffn_block_train_fwd(*wargs)
            full_ms = time_ms(lambda: fused_ffn_block_train_fwd(*wargs))
            bargs = (x, w1, b1, w2, b2, g2, seed, rate, 1e-12, dy)
            gfull = fused_ffn_block_train_bwd(*bargs)
            gfull_ms = time_ms(lambda: fused_ffn_block_train_bwd(*bargs))
            # dy_pre: the LayerNorm's backward of dy, what autograd hands
            # the shards, from the plain forward's statistics
            *_, yhat, inv = _forward_to_stats(x, w1, b1, w2, b2, seed, rate,
                                              1e-12)
            dyn = dy.float() * g2
            dy_pre = (inv * (dyn - dyn.mean(-1, keepdim=True) - yhat * (
                dyn * yhat).mean(-1, keepdim=True))).contiguous()
            del yhat, inv, dyn
            for Fl in (FF // 2, FF // 4):
                T = FF // Fl
                tag = f"rows={R} F={Fl} rate={rate}"
                parts, grads = [], []
                for m in range(T):
                    sl = slice(m * Fl, (m + 1) * Fl)
                    sw = (w1[sl].contiguous(), b1[sl].contiguous(),
                          w2[:, sl].contiguous())
                    fa_ = (x, *sw, b2 if m == 0 else None, seed, rate)
                    ba_ = (x, *sw, seed, rate, dy_pre)
                    out = fused_ffn_block_train_partial_fwd(*fa_)
                    err = compare(f"{fwd} shard {m} {tag}", out,
                                  fused_ffn_block_train_partial_plain(*fa_))
                    rows[fwd]["max_abs_err"] = max(
                        rows[fwd].get("max_abs_err", 0.0), err)
                    got = fused_ffn_block_train_partial_bwd(*ba_)
                    want = fused_ffn_block_train_partial_bwd_plain(*ba_)
                    err = compare(f"{bwd} dx_part shard {m} {tag}", got[0],
                                  want[0])
                    rows[bwd]["max_abs_err"] = max(
                        rows[bwd].get("max_abs_err", 0.0), err)
                    for gname, a, w in zip(("dW1", "db1", "dW2", "db2"),
                                           got[1:], want[1:]):
                        compare_norm(f"{bwd} {gname} shard {m} {tag}", a, w,
                                     FFN_GRAD_RTOL)
                    del want
                    if rate == 0.0 and m > 0:
                        same = torch.equal(out,
                                           fused_ffn_block_partial(*fa_[:4]))
                        print(f"  #9 partial {tag} shard {m} (no b2) bit for "
                              f"bit #3's partial mode: {same}")
                        if not same:
                            fail(f"#9's partial mode at rate 0 is not #3's "
                                 f"({tag})")
                    if m == T - 1:
                        repeat_bitwise(
                            f"#9 partial shard {m} {tag}",
                            lambda: fused_ffn_block_train_partial_fwd(*fa_),
                            out)
                        repeat_bitwise(
                            f"#10 partial shard {m} {tag}",
                            lambda: fused_ffn_block_train_partial_bwd(*ba_),
                            got)
                    if m == 0:
                        for key, kern, plain, a_, back, base in (
                                (fwd, fused_ffn_block_train_partial_fwd,
                                 fused_ffn_block_train_partial_plain, fa_,
                                 False, full_ms),
                                (bwd, fused_ffn_block_train_partial_bwd,
                                 fused_ffn_block_train_partial_bwd_plain,
                                 ba_, True, gfull_ms)):
                            t = dict(ms=time_ms(lambda: kern(*a_)),
                                     plain_ms=time_ms(lambda: plain(*a_),
                                                      iters=3),
                                     library_ms=None)
                            t["bound_ms"], t["bound_by"] = bound(
                                *partial_ffn_train_bytes_flops(R, Fl, back))
                            g_ms = graph_ms(lambda: kern(*a_))
                            print(f"    {key} {tag}: kernel {t['ms']:.4f} "
                                  f"ms (graph {g_ms:.4f}), plain "
                                  f"{t['plain_ms']:.4f} ms, bound "
                                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
                                  f"; whole kernel (F = {FF}) on the same "
                                  f"input {base:.4f} ms, partial / whole "
                                  f"{t['ms'] / base:.2f}")
                            if (R, Fl, rate) == (TP_FFN_ROWS[0], FF // 2,
                                                 0.1):
                                rows[key].update(t)
                    parts.append(out)
                    grads.append(got)
                compare(f"#9 partials {tag} summed + residual + LayerNorm "
                        f"vs #9 whole",
                        layer_norm_f32(sum(parts) + x.float(), g2, be2,
                                       1e-12).to(x.dtype), full)
                compare(f"#10 partials {tag}: dx summed + dy_pre vs #10 "
                        f"whole", sum(gr[0].float() for gr in grads) + dy_pre,
                        gfull[0])
                for i, dim, gname in ((1, 0, "dW1"), (2, 0, "db1"),
                                      (3, 1, "dW2")):
                    compare_norm(f"#10 partials {tag}: {gname} gathered vs "
                                 f"#10 whole", torch.cat(
                                     [gr[i] for gr in grads], dim),
                                 gfull[i], FFN_GRAD_RTOL)
                compare_norm(f"#10 partials {tag}: db2 (shard 0) vs #10 "
                             f"whole", grads[0][4], gfull[4], FFN_GRAD_RTOL)
                del parts, grads
            del gfull, dy_pre
    torch.cuda.empty_cache()

    # the int8 row-parallel product at the attention output's (K = 768)
    # and the FFN's second dense's (K = 3072) widths
    x_all = torch.randn(TP_INT8_ROWS, FF, generator=gen, device="cuda")
    for K in (H, FF):
        xk = x_all[:, :K].contiguous()
        w = torch.randn(H, K, generator=gen, device="cuda") * 0.05
        whole_xq, _ = int8_ops.quantize_rows(xk)
        whole_wq, _ = int8_ops.quantize_weight(w)
        whole = int8_ops.int8_product(whole_xq, whole_wq)
        for T in (2, 4):
            xs, ws = xk.chunk(T, dim=1), w.chunk(T, dim=1)
            x_max = torch.stack([int8_ops.row_maxima(p) for p in xs]).amax(0)
            w_max = torch.stack([int8_ops.channel_maxima(p)
                                 for p in ws]).amax(0)
            codes, acc = True, torch.zeros_like(whole)
            for m in range(T):
                xq, _ = int8_ops.quantize_rows(xs[m], x_max)
                wq_, _ = int8_ops.quantize_weight(ws[m], w_max)
                codes &= (torch.equal(xq, whole_xq.chunk(T, dim=1)[m])
                          and torch.equal(wq_, whole_wq.chunk(T, dim=1)[m]))
                acc += int8_ops.int8_product(xq.contiguous(), wq_)
            same = torch.equal(acc, whole)
            print(f"  int8 row-parallel product, {TP_INT8_ROWS} rows, K = "
                  f"{K} on T = {T} shards from the group's maxima: codes "
                  f"bit for bit the whole product's {codes}, int32 sums "
                  f"{same}")
            if not (codes and same):
                fail(f"the int8 row-parallel product on T = {T} shards (K = "
                     f"{K}) is not the whole product")
    del x_all


def tp_head_offset_checks(gen):
    """#5 and #6a on each shard of T = 2 and 4 of the heads, with the head
    offset in their Philox key, bit for bit against the same heads of the
    launch over all 12 (output, dQ, row statistics, keep bits), at rate
    0.1; the plain version with the offset against the kernel; each timed
    beside the whole launch. Returns {(kernel, n): ms}."""
    rate = 0.1
    times = {}
    for b, L in TP_TRAIN_SHAPES:
        q, k, v, bias = heads(gen, b, L)
        g = torch.randn(b, L, N, D, generator=gen, device="cuda").bfloat16()
        args = (q, k, v, bias, TRAIN_SEED, rate)
        out = flash_attention_train_fwd(*args)
        dq, st, bits = flash_attention_train_bwd_dq(*args, g)
        times[("fwd", N, b, L)] = time_ms(
            lambda: flash_attention_train_fwd(*args))
        times[("dq", N, b, L)] = time_ms(
            lambda: flash_attention_train_bwd_dq(*args, g))
        for T in (2, 4):
            n = N // T
            same = []
            for m in range(T):
                sl = slice(m * n, (m + 1) * n)
                sargs = (q[:, :, sl], k[:, :, sl], v[:, :, sl], bias,
                         TRAIN_SEED, rate)
                gs = g[:, :, sl].contiguous()
                o = flash_attention_train_fwd(*sargs, m * n, N)
                sdq, sst, sbits = flash_attention_train_bwd_dq(
                    *sargs, gs, m * n, N)
                same.append(torch.equal(o, out[:, :, sl])
                            and torch.equal(sdq, dq[:, :, sl])
                            and torch.equal(sst, st[:, :, sl])
                            and torch.equal(sbits, bits[:, sl]))
                if m == 1 and T == 2:
                    unkeyed = flash_attention_train_fwd(*sargs)
                    compare(f"#5 shard 1 of 2 with the offset vs its plain "
                            f"version B={b} L={L}", o,
                            flash_attention_train_plain(*sargs, m * n, N))
                    times[("fwd", n, b, L)] = time_ms(
                        lambda: flash_attention_train_fwd(*sargs, m * n, N))
                    times[("dq", n, b, L)] = time_ms(
                        lambda: flash_attention_train_bwd_dq(*sargs, gs,
                                                             m * n, N))
                    print(f"  #5 shard 1 of 2 without the offset differs "
                          f"from the whole launch's heads 6-11: "
                          f"{not torch.equal(unkeyed, out[:, :, sl])}")
            print(f"  #5 / #6a by global head, T={T} B={b} L={L}: each "
                  f"shard's output, dQ, statistics and keep bits bit for "
                  f"bit the whole launch's heads: {same}")
            if not all(same):
                fail(f"#5/#6a with a head offset differ from the whole "
                     f"launch at T={T} B={b} L={L}")
        print(f"    #5 at ({b}, {L}): 12 heads {times[('fwd', N, b, L)]:.4f}"
              f" ms, 6 heads {times[('fwd', N // 2, b, L)]:.4f} ms; #6a: 12 "
              f"heads {times[('dq', N, b, L)]:.4f} ms, 6 heads "
              f"{times[('dq', N // 2, b, L)]:.4f} ms")
    return times


TP_DIR = os.path.join("build", "tp_smoke")
TP_STEP_B = 32              # the mlm step of (b) at (32, 162)
TP_STEP_COUNT = 2           # mlm steps a part of (b), the first a warm-up
TP_STEPS, TP_STOP = 2, 1    # the driver's steps, and where it is saved
TP_SCORE_REPS = 1           # one process's timed batches a bucket and part
FFN_TP_KERNELS = (fused_ffn_block_train_partial_fwd,
                  fused_ffn_block_train_partial_bwd)


def tp_score_launches(part, L, layers):
    """The launches of one scored batch at --n_model 2: the default route
    #2's (or #7's under UC2_ATTN_V2) and #3's partial modes where the
    gates open, #1 on 6 heads below L = 128; int8 #1 and the four int8
    products in every layer, nothing fused."""
    if part == "int8":
        return {"flash_attention": layers, "int8_product": 4 * layers}
    want = {"fused_ffn_block_partial": layers}
    attn = "fused_attn_block_v2_partial" if part == "v2" else \
        "fused_attn_block_partial"
    want[attn if fused_block_profitable(L, N) else "flash_attention"] = layers
    return want
# the updated parameters read back from the two-process step
TP_PARAM_KEYS = ("roberta.layer.0.attention.qkv.weight",
                 "roberta.layer.11.output_dense.weight",
                 "roberta.embeddings.word_embeddings.weight", "cls.bias")

TP_WORKER = r"""
import json, os, sys, time
import torch
rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from uc2_torch.parallel import mesh as M, multihost as MH, tensor as TP
assert MH.maybe_initialize(addr, 2, rank, backend="gloo", device="cuda")
M.init_grid(2)
torch.backends.cuda.matmul.allow_tf32 = False
from uc2_torch.config import UC2Config
from uc2_torch.models.finetune import UC2ForImageTextRetrieval
from uc2_torch.models.pretraining import UC2ForPretraining
from uc2_torch.ops import flash_attention as fa, fused_block as fb
from uc2_torch.ops import ffn_train as ft, int8
from uc2_torch.ops.dropout import DropoutRng
from uc2_torch.training.optim import build_optimizer, constant
from uc2_torch.training.step import train_step
KS = (fa.flash_attention, fa.flash_attention_train_fwd,
      fa.flash_attention_train_bwd_dq, fa.flash_attention_train_bwd_dkdv,
      fb.fused_attn_block, fb.fused_ffn_block, fb.fused_attn_block_partial,
      fb.fused_ffn_block_partial, fb.fused_attn_block_v2_partial,
      ft.fused_ffn_block_train_partial_fwd,
      ft.fused_ffn_block_train_partial_bwd, int8.int8_product)
def reset():
    for k in KS:
        k.launches = 0
    spent.update(ms=0.0, n=0, mb=0.0)
def counts():
    return {k.__name__: k.launches for k in KS if k.launches}
spent = {"ms": 0.0, "n": 0, "mb": 0.0}
ar0 = TP._all_reduce
def ar(t, *a, **k):
    # the model group's all-reduces, timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ar0(t, *a, **k)
    torch.cuda.synchronize()
    spent["ms"] += (time.perf_counter() - t0) * 1e3
    spent["n"] += 1
    spent["mb"] += t.numel() * t.element_size() / 1e6
    return r
TP._all_reduce = ar
meta = json.load(open(f"{d}/meta.json"))
cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
    dtype="bfloat16")
out = {}
model = TP.place_model(UC2ForImageTextRetrieval(cfg, device="cuda", seed=0))
batches = torch.load(f"{d}/score_batches.pt", weights_only=True)
batches = {L: {k: v.cuda() for k, v in b.items()} for L, b in batches.items()}
def score(m, part, warm):
    # one counted, timed batch a bucket (after a warm-up call where the
    # bucket's shapes are new to the process)
    scores = {}
    for L, b in batches.items():
        if warm:
            m.scores(b)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        s = m.scores(b)
        torch.cuda.synchronize()
        out[f"{part}_{L}"] = {"launches": counts(), "collective": dict(spent),
                              "ms": [(time.perf_counter() - t0) * 1e3]}
        scores[L] = s.float().cpu()
    torch.save(scores, f"{d}/{part}_{rank}.pt")
score(model, "score", True)
# the kernel routes of the slice: UC2_ATTN_V2 (#7's partial mode where
# the gate opens), and int8 serving (the row-parallel products)
os.environ["UC2_ATTN_V2"] = "1"
score(model, "v2", False)
del os.environ["UC2_ATTN_V2"]
score(model.serving("int8"), "int8", False)
del model
torch.cuda.empty_cache()
batch = {k: v.cuda() for k, v in
         torch.load(f"{d}/mlm_batch.pt", weights_only=True).items()}
def steps(n, part):
    model = TP.place_model(UC2ForPretraining(cfg.replace(
        use_pallas_attention="pallas-train"), device="cuda", seed=0))
    opt = build_optimizer(model, constant(1e-4), weight_decay=0.0,
                          betas=(0.9, 0.98), grad_norm=2.0)
    recs = []
    for i in range(n):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(model, opt, batch, DropoutRng(7, "cuda"), task="mlm")
        torch.cuda.synchronize()
        recs.append({"ms": (time.perf_counter() - t0) * 1e3,
                     "loss": m["loss"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "launches": counts(), "collective": dict(spent)})
        if i == 0 and part == "steps":
            whole = TP.full_state_dict(model)
            if rank == 0:
                torch.save({k: whole[k].cpu() for k in meta["keys"]},
                           f"{d}/params.pt")
            del whole
    out[part] = recs
    del model, opt
    torch.cuda.empty_cache()
steps(meta["steps"], "steps")
# #9 and #10 in their partial modes
os.environ["UC2_FFN_TRAIN"] = "1"
steps(meta["steps"], "ffn_steps")
del os.environ["UC2_FFN_TRAIN"]
out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
json.dump(out, open(f"{d}/tp_{rank}.json", "w"))
MH.shutdown()
"""

# ``python -m uc2_torch.itm --quant int8 --n_model 2`` in one process of
# the model group: its validations and tests scored through the int8
# row-parallel products
TP_ITM = r"""
import json, sys, time
import torch
rank, addr, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from uc2_torch import itm
from uc2_torch.ops import flash_attention as fa, int8
from uc2_torch.parallel import multihost as MH, tensor as TP
spent = {"ms": 0.0, "n": 0}
ar0 = TP._all_reduce
def ar(t, *a, **k):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ar0(t, *a, **k)
    torch.cuda.synchronize()
    spent["ms"] += (time.perf_counter() - t0) * 1e3
    spent["n"] += 1
    return r
TP._all_reduce = ar
meta = json.load(open(f"{d}/meta.json"))
argv = meta["itm_argv"] + [
    "--coordinator_address", addr, "--num_processes", "2",
    "--process_id", str(rank), "--dist_backend", "gloo", "--n_model", "2"]
parser = itm.build_parser()
opts = itm.parse_with_config(parser, argv)
itm.apply_reference_config_compat(opts, parser, argv)
fa.flash_attention.launches = int8.int8_product.launches = 0
t0 = time.perf_counter()
run = itm.main(opts)
torch.cuda.synchronize()
json.dump({"step": run.step, "val": run.val, "results": run.results,
           "seconds": time.perf_counter() - t0,
           "flash_attention": fa.flash_attention.launches,
           "int8_product": int8.int8_product.launches,
           "collective": spent,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
          open(f"{d}/itm_{rank}.json", "w"))
MH.shutdown()
"""
# its stores at uc2-base's widths: training on TP_ITM_IMGS images x 2
# captions; validation (after the last of TP_ITM_STEPS steps) on
# TP_ITM_VAL_TXTS texts and the test on all of a store of TP_ITM_TEST
# images x 1 caption, 10-36 regions (one bucket: a scored batch a text)
TP_ITM_IMGS, TP_ITM_TEST, TP_ITM_VAL_TXTS, TP_ITM_STEPS = 16, 4, 2, 2
# the UC2_ATTN_V2 and int8 scores against one process's (the default
# route's, through #2's and #3's partial modes, read 5.9e-3 - 7.8e-3 on
# an H100 80GB HBM3 at 700 W)
TP_SCORE_TOL = 1e-2


def phase_tp(card, gen):
    """Tensor parallelism (``--n_model``, the module's docstring, phase
    21). Returns (the JSON rows of #2's and #3's partial modes, the
    launches of the model group's runs)."""
    print(f"== tp: tensor parallelism, (a) the kernels' partial modes and "
          f"head offsets, (b) two processes over gloo on the one card at "
          f"--n_model 2 [{card}]")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    try:
        return _phase_tp(card, gen)
    finally:
        shutil.rmtree(TP_DIR, ignore_errors=True)
        torch.cuda.empty_cache()


def _phase_tp(card, gen):
    rows = tp_partial_checks(gen)
    tp_route_checks(gen, rows)
    tp_head_offset_checks(gen)
    torch.cuda.empty_cache()
    launches = no_launches()
    py = sys.executable
    cfg = UC2Config.from_json_file("config/uc2-base.json").replace(
        dtype="bfloat16")
    layers = cfg.num_hidden_layers
    # scored batches of B = 64 at the three buckets, and one mlm batch
    txt_db, img_db = synth_gallery(seed=3, n_imgs=N_IMGS, txt_per_img=1,
                                   vocab=cfg.vocab_size, img_dim=cfg.img_dim)
    edges = retrieval.bucket_edges(TXT_LEN, NUM_BB)
    names = sorted(img_db.name2nbb)
    bucket_of = np.searchsorted(edges, [img_db.name2nbb[i] for i in names])
    batches, rows_n = {}, {}
    for bi, nb in enumerate(edges):
        ids_b = [im for im, bk in zip(names, bucket_of) if bk == bi]
        batch, rows_n[TXT_LEN + nb] = bucket_batch(img_db, ids_b, txt_db,
                                                   txt_db.ids[0], nb)
        batches[TXT_LEN + nb] = batch
    tcfg = cfg.replace(use_pallas_attention="pallas-train")
    mlm = mix_batches(tcfg, 1, TRAIN_SEED)[0]["mlm"][0]
    mlm = {k: v[:TP_STEP_B] for k, v in mlm.items()}
    torch.save({L: {k: v.cpu() for k, v in b.items()}
                for L, b in batches.items()},
               os.path.join(TP_DIR, "score_batches.pt"))
    torch.save({k: v.cpu() for k, v in mlm.items()},
               os.path.join(TP_DIR, "mlm_batch.pt"))
    with open(os.path.join(TP_DIR, "meta.json"), "w") as f:
        json.dump({"steps": TP_STEP_COUNT, "keys": list(TP_PARAM_KEYS)}, f)
    # one process on the same weights and inputs: the default route,
    # UC2_ATTN_V2 and int8 scores, and the mlm step without and with
    # UC2_FFN_TRAIN=1
    model = UC2ForImageTextRetrieval(cfg, device="cuda", seed=0)
    parts = {"score": (model, None), "v2": (model, "1"),
             "int8": (model.serving("int8"), None)}
    one, one_ms = {}, {}
    for part, (m, v2) in parts.items():
        with env_set("UC2_ATTN_V2", v2):
            with torch.no_grad():
                one[part] = {L: m.scores(b).float().cpu()
                             for L, b in batches.items()}
            for L, b in batches.items():
                ts = []
                for _ in range(TP_SCORE_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.scores(b)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                one_ms[(part, L)] = ts
    del model, parts, m
    one_steps = {}
    for part, ffn in (("steps", None), ("ffn_steps", "1")):
        with env_set("UC2_FFN_TRAIN", ffn):
            model = UC2ForPretraining(tcfg, device="cuda", seed=0)
            opt = build_optimizer(model, constant(1e-4), weight_decay=0.0,
                                  betas=(0.9, 0.98), grad_norm=2.0)
            m = train_step(model, opt, mlm, DropoutRng(7, "cuda"), task="mlm")
            rec = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
            if part == "steps":
                sd = model.state_dict()
                one_params = {k: sd[k].detach().float().cpu()
                              for k in TP_PARAM_KEYS}
                del sd
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, mlm, DropoutRng(7, "cuda"), task="mlm")
            torch.cuda.synchronize()
            rec["ms"] = (time.perf_counter() - t0) * 1e3    # the second step
            one_steps[part] = rec
            del model, opt, m
            torch.cuda.empty_cache()

    t0 = time.perf_counter()
    addr = f"127.0.0.1:{free_port()}"
    path = os.path.join(TP_DIR, "tp_worker.py")
    with open(path, "w") as f:
        f.write(TP_WORKER)
    res = spawn([[py, path, str(r), addr, TP_DIR] for r in (0, 1)])
    worker_s = time.perf_counter() - t0
    if spawned_ok("tp: the two-process scores and steps", res):
        outs = []
        for r in (0, 1):
            with open(os.path.join(TP_DIR, f"tp_{r}.json")) as f:
                outs.append(json.load(f))
        for part, tol, what in (("score", SCORE_TOL, "default-route"),
                                ("v2", TP_SCORE_TOL, "UC2_ATTN_V2=1"),
                                ("int8", TP_SCORE_TOL, "int8")):
            for r in (0, 1):
                tp_scores = torch.load(os.path.join(TP_DIR,
                                                    f"{part}_{r}.pt"))
                for L, want in one[part].items():
                    n = rows_n[L]
                    got = tp_scores[L]
                    err = float((got[:n] - want[:n]).abs().max())
                    rec = outs[r][f"{part}_{L}"]
                    want_k = tp_score_launches(part, L, layers)
                    ok = (bool(torch.isfinite(got).all()) and err <= tol
                          and rec["launches"] == want_k)
                    coll = rec["collective"]
                    print(f"  (b) {what} scores, process {r} of 2, B = {B}, "
                          f"L = {L}: max|n_model 2 - one process| {err:.4e} "
                          f"(tolerance {tol}; bit for bit "
                          f"{torch.equal(got[:n], want[:n])}), launches "
                          f"{rec['launches']} (want {want_k}); ms/batch "
                          f"{[round(x, 1) for x in rec['ms']]} against one "
                          f"process's "
                          f"{[round(x, 1) for x in one_ms[(part, L)]]}; "
                          f"the model group's all-reduces {coll['n']} a "
                          f"batch, {coll['mb']:.1f} MB, {coll['ms']:.1f} ms "
                          f"{'ok' if ok else 'FAIL'} [{card}]")
                    if not ok:
                        fail(f"tp: the {part} scores at L = {L} (process "
                             f"{r}) are not one process's, or a kernel was "
                             f"not launched")
                    if r == 0:
                        for k, c in rec["launches"].items():
                            if k in launches:
                                launches[k] += c
        got_params = torch.load(os.path.join(TP_DIR, "params.pt"))
        p_err = {k.split(".")[-2]: float(
            (got_params[k] - v).abs().max() / v.abs().max())
            for k, v in one_params.items()}
        for part, extra in (("steps", ()),
                            ("ffn_steps", FFN_TP_KERNELS)):
            want_k = {k.__name__: layers for k in TRAIN_KERNELS + extra}
            ref = one_steps[part]
            for r in (0, 1):
                st = outs[r][part]
                first = st[0]
                d_loss = abs(first["loss"] - ref["loss"])
                d_norm = abs(first["grad_norm"] - ref["grad_norm"]) / ref[
                    "grad_norm"]
                ok = (d_loss <= STEP_LOSS_TOL and d_norm <= STEP_NORM_RTOL
                      and first["launches"] == want_k)
                coll = [(x["collective"]["n"],
                         round(x["collective"]["mb"], 1),
                         round(x["collective"]["ms"], 1)) for x in st]
                print(f"  (b) mlm step{' with UC2_FFN_TRAIN=1' if extra else ''}"
                      f" at ({TP_STEP_B}, {TXT_LEN + NUM_BB}), dropout 0.1, "
                      f"pallas-train, process {r} of 2: loss "
                      f"{first['loss']:.6f} vs one process's "
                      f"{ref['loss']:.6f} (|diff| {d_loss:.2e}, tolerance "
                      f"{STEP_LOSS_TOL}), grad norm {first['grad_norm']:.6f} "
                      f"vs {ref['grad_norm']:.6f} (relative {d_norm:.2e}, "
                      f"tolerance {STEP_NORM_RTOL}); launches "
                      f"{first['launches']} (want {want_k}); ms/step "
                      f"{[round(x['ms'], 1) for x in st]} (the first with "
                      f"the warm-up) against one process's second step "
                      f"{ref['ms']:.1f}; the model group's all-reduces a "
                      f"step (count, MB, ms) {coll}; peak "
                      f"{outs[r]['peak_gib']:.1f} GiB "
                      f"{'ok' if ok else 'FAIL'} [{card}]")
                if not ok:
                    fail(f"tp: the two-process mlm {part} (process {r}) is "
                         f"not the one-process step")
                if r == 0:
                    for k, c in first["launches"].items():
                        launches[k] += c
        print(f"  (b) the updated parameters after the step, gathered, "
              f"against one process's (max |diff| over max |one|): {p_err}"
              f"; {worker_s:.1f} s with the processes' start")

    # the pretraining driver at --n_model 2: saved at TP_STOP, resumed
    t0 = time.perf_counter()
    cfg_path = os.path.join(TP_DIR, "uc2-base-pallas-train.json")
    with open(cfg_path, "w") as f:
        json.dump(tcfg.to_dict(), f)
    corpus = [synth_corpus(os.path.join(TP_DIR, lang), n_imgs=DIST_IMGS,
                           txt_per_img=2, seed=seed, paired=lang == "de")
              for lang, seed in (("en", 0), ("de", 1))]
    out_dir = os.path.join(TP_DIR, "driver")
    meta = {"stop": TP_STOP, "driver_out": out_dir, "extra": [
        "--n_model", "2"], "driver_argv": dist_driver_argv(
            out_dir, corpus, cfg_path, "--save_steps", str(TP_STOP),
            "--num_train_steps", str(TP_STEPS),
            "--train_batch_size", "5120")}
    with open(os.path.join(TP_DIR, "meta.json"), "w") as f:
        json.dump(meta, f)
    path = os.path.join(TP_DIR, "driver.py")
    with open(path, "w") as f:
        f.write(DIST_DRIVER)
    addr = f"127.0.0.1:{free_port()}"
    res = spawn([[py, path, str(r), addr, TP_DIR] for r in (0, 1)])
    drv_s = time.perf_counter() - t0
    if spawned_ok("tp: the two-process driver at --n_model 2", res):
        outs = []
        for r in (0, 1):
            with open(os.path.join(TP_DIR, f"driver_{r}.json")) as f:
                outs.append(json.load(f))
        keeps = [np.load(os.path.join(TP_DIR, f"keep_{r}.npy"))
                 for r in (0, 1)]
        with open("config/uc2_pretrain.json") as f:
            accum = json.load(f)["gradient_accumulation_steps"]
        for r, o in enumerate(outs):
            want_n = TP_STOP * layers * accum
            ok = (o["restored_step"] == TP_STOP and o["model_bitwise"]
                  and o["optimizer_bitwise"] and all(o["streams"])
                  and o["second"]["step"] == TP_STEPS
                  and all(n == want_n for n in o["launches_first"].values())
                  and all(np.isfinite(v) for part in ("first", "second")
                          for _, _, v in o[part]["losses"]))
            logs = o["first"]["logs"] + o["second"]["logs"]
            ms = [round((t1 - t0_) * 1e3 / (s1 - s0), 1)
                  for (s0, t0_, _), (s1, t1, _) in zip(logs, logs[1:])
                  if s1 > s0 and s0 != TP_STOP]
            print(f"  (b) python -m uc2_torch.pretrain --n_model 2, process "
                  f"{r} of 2 (gloo, --train_batch_size 5120): steps "
                  f"1-{TP_STOP}, saved, resumed to {o['second']['step']}; "
                  f"losses {[(s, t, round(v, 4)) for p in ('first', 'second') for s, t, v in o[p]['losses']]}"
                  f"; restored step {o['restored_step']}, shards bit for bit "
                  f"{o['model_bitwise']}, optimizer (gathered) bit for bit "
                  f"{o['optimizer_bitwise']}; launches of steps 1-{TP_STOP}"
                  f" {o['launches_first']} (want {want_n} each); loop "
                  f"ms/step {ms}; the model group's all-reduces over the two "
                  f"runs {o['collective']['n']} in "
                  f"{o['collective']['ms'] / 1e3:.1f} s; saves "
                  f"{[round(t, 2) for t in o['first']['saves'] + o['second']['saves']]}"
                  f" s; peak {o['peak_gib']:.1f} GiB {'ok' if ok else 'FAIL'}"
                  f" [{card}]")
            if not ok:
                fail(f"tp: the driver at --n_model 2 (process {r}) did not "
                     f"resume bit for bit or missed a launch")
            if r == 0:
                for name, n in o["launches_first"].items():
                    launches[name] += n
        step, ckpt = ckpt_state(os.path.join(out_dir, "restore.ckpt"))
        V = cfg.vocab_size
        whole = (step == TP_STEPS and ckpt[
            "param roberta.embeddings.word_embeddings.weight"].shape[0] == V
            and ckpt["param cls.bias"].shape[0] == V)
        print(f"  restore.ckpt of step {step}: the whole model (vocabulary "
              f"rows {V}) {whole}; both processes drew the same dropout "
              f"masks {np.array_equal(keeps[0], keeps[1])}; "
              f"{drv_s:.1f} s with the stores and the processes' start")
        if not (whole and np.array_equal(keeps[0], keeps[1])):
            fail("tp: restore.ckpt is not the whole model, or the model "
                 "group drew different dropout masks")

    # python -m uc2_torch.itm --quant int8 --n_model 2: the validations
    # and the test scored through the int8 row-parallel products
    t0 = time.perf_counter()
    st = synth_corpus(os.path.join(TP_DIR, "itm"), n_imgs=TP_ITM_IMGS,
                      txt_per_img=2, seed=5)
    te = synth_corpus(os.path.join(TP_DIR, "itm_test"), n_imgs=TP_ITM_TEST,
                      txt_per_img=1, seed=6, max_bb=36)
    out_dir = os.path.join(TP_DIR, "itm_out")
    with open(os.path.join(TP_DIR, "meta.json"), "w") as f:
        json.dump({"itm_argv": [
            "--model_config", "config/uc2-base.json", "--dtype", "bfloat16",
            "--train_txt_db", st["txt_db"], "--train_img_db", st["img_db"],
            "--val_txt_db", te["txt_db"], "--val_img_db", te["img_db"],
            "--test_datasets", json.dumps([{"name": "t", "db": te["txt_db"],
                                            "img": te["img_db"]}]),
            "--output_dir", out_dir, "--quant", "int8",
            "--train_batch_size", "40", "--gradient_accumulation_steps", "1",
            "--num_train_steps", str(TP_ITM_STEPS), "--valid_steps",
            str(TP_ITM_STEPS),
            "--eval_txt_limit", str(TP_ITM_VAL_TXTS), "--eval_batch_size",
            str(B), "--save_steps", "100", "--warmup_steps", "1",
            "--log_steps", "1", "--seed", "0"]}, f)
    path = os.path.join(TP_DIR, "tp_itm.py")
    with open(path, "w") as f:
        f.write(TP_ITM)
    addr = f"127.0.0.1:{free_port()}"
    res = spawn([[py, path, str(r), addr, TP_DIR] for r in (0, 1)])
    itm_s = time.perf_counter() - t0
    if spawned_ok("tp: python -m uc2_torch.itm --quant int8 --n_model 2", res):
        outs = []
        for r in (0, 1):
            with open(os.path.join(TP_DIR, f"itm_{r}.json")) as f:
                outs.append(json.load(f))
        with open(os.path.join(out_dir, "test_results.json")) as f:
            written = json.load(f)
        for r, o in enumerate(outs):
            ok = (o["step"] == TP_ITM_STEPS and len(o["val"]) == 1
                  and o["results"] == written and set(written) == {"t"}
                  and o["int8_product"] > 0
                  and o["int8_product"] == 4 * o["flash_attention"]
                  and o["val"] == outs[0]["val"])
            print(f"  (b) python -m uc2_torch.itm --quant int8 --n_model 2, "
                  f"process {r} of 2 (gloo; {TP_ITM_IMGS} images x 2 "
                  f"captions, {TP_ITM_STEPS} steps, validation on "
                  f"{TP_ITM_VAL_TXTS} texts and the test on {TP_ITM_TEST} "
                  f"of a one-bucket store): step "
                  f"{o['step']}, validations {o['val']}, test "
                  f"{o['results']} (test_results.json the same "
                  f"{o['results'] == written}); int8 products "
                  f"{o['int8_product']}, #1 launches {o['flash_attention']} "
                  f"(4 products a #1 launch: 12 layers a scored batch); the "
                  f"model group's all-reduces {o['collective']['n']} in "
                  f"{o['collective']['ms'] / 1e3:.1f} s; the run "
                  f"{o['seconds']:.1f} s, peak {o['peak_gib']:.1f} GiB "
                  f"{'ok' if ok else 'FAIL'} [{card}]")
            if not ok:
                fail(f"tp: itm --quant int8 --n_model 2 (process {r}) did "
                     f"not run its steps, validations and test through the "
                     f"int8 products")
            if r == 0:
                launches["flash_attention"] += o["flash_attention"]
        print(f"  (b) the itm driver: {itm_s:.1f} s with the stores and the "
              f"processes' start")
    return rows, launches


# ``--times [group ...]``: the timing phases by name, in this order when
# none is named
TIMES = {"stream": (phase_stream_times, "gen"),
         "block": (phase_block_times, "gen"),
         "ffn": (phase_ffn_times, "gen", "card"),
         "segment": (phase_segment_times, "gen", "card"),
         "layer": (phase_layer_times, "gen", "card"),
         "embed": (time_embedding_backward, "card"),
         "step": (time_mlm_step, "card")}


def main() -> int:
    if sys.argv[2:] and (sys.argv[1] != "--times"
                         or not set(sys.argv[2:]) <= set(TIMES)):
        print(f"usage: chip_smoke.py [--times [{' | '.join(TIMES)} ...]]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    os.environ.pop("UC2_FFN_TRAIN", None)   # the mix phase sets it itself
    start = time.perf_counter()

    def timed(phase, *args):
        """Run one phase and print its wall time."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"  [{phase.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    name, card = timed(phase_device)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:2] == ["--times"]:
        groups = sys.argv[2:] or list(TIMES)
        for group in groups:
            phase, *args = TIMES[group]
            timed(phase, *(card if a == "card" else gen for a in args))
        return 1 if FAILURES else 0
    rows = timed(phase_kernels, gen)
    train_rows = timed(phase_train_kernels, gen)
    rows.update(train_rows)
    ffn_rows = timed(phase_ffn_kernels, gen, card)
    rows.update(ffn_rows)
    rows.update(timed(phase_long_kernels, gen, train_rows))
    rows.update(timed(phase_route_kernels, gen, card))
    rows.update(timed(phase_lab_kernels, gen, card))
    launches = timed(phase_slice, card)

    def add(more):
        """Launches of a later phase added to the count (#3 runs in the
        slice, the routes and the lab)."""
        for kernel, n in more.items():
            launches[kernel] = launches.get(kernel, 0) + n

    add(timed(phase_routes, card))
    train_launches, busy = timed(phase_train, card, train_rows)
    launches.update(train_launches)
    launches.update(timed(phase_mix, card, busy, ffn_rows))
    long_launches, long_batch = timed(phase_long, card)
    launches.update(long_launches)
    add(timed(phase_flash_train, card, long_batch))
    add(timed(phase_lab, card))
    add(timed(phase_pretrain, card))
    add(timed(phase_objectives, card))
    add(timed(phase_itm, card, rows, gen))
    add(timed(phase_finetune, card, rows, gen))
    add(timed(phase_dist, card, rows, gen))
    add(timed(phase_int8, card, gen))
    add(timed(phase_runbook, card))
    add(timed(phase_remat, card))
    tp_rows, tp_launches = timed(phase_tp, card, gen)
    rows.update(tp_rows)
    add(tp_launches)
    print(f"  [all phases: {time.perf_counter() - start:.1f} s]")
    for r in rows.values():
        r["launches"] = launches[r["name"]]
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
