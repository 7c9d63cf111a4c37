"""UC2 multi-task pretraining driver (port of the repository's pretrain.py).

    python -m uc2_torch.pretrain --config config/uc2_pretrain.json [flags]

The same flags and config JSONs as ``pretrain.py`` (CLI wins over the
JSON), plus ``--device`` (``cuda`` unless ``cpu`` is asked for). The path:
U2S stores -> ``data/db.py``'s databases -> the task datasets ->
``TaskLoader``s -> ``MetaLoader`` (one task per optimizer step, drawn
from (seed, step) with the mix ratios; with accumulation the step's
micro-batches stacked on a leading axis) -> ``PrefetchLoader`` (a worker
thread assembles batches and copies them to the card) -> ``train_step``
-> validation (``eval_step``) -> milestones and ``restore.ckpt``.

* Dropout is a pure function of (seed, global step): each step builds its
  ``DropoutRng`` from ``step_seed``, as the reference folds the step into
  its key, so a resumed run draws the masks of an uninterrupted one.
  With ``--host_accum`` the micro-step ``step * accum + k`` keys each
  micro-batch.
* Resume restores the model, the optimizer (update count and AdamW's
  moments) and the input stream's state saved with them (or replays the
  stream with ``fast_forward`` when that file is missing): the resumed
  run is the uninterrupted one, step for step.
* Losses stay device tensors and are read ``--runahead`` steps late; a
  ``--log_steps`` boundary reads them all (so its time is honest).
* Data parallel across processes, one GPU each: one command a process,
  ``--coordinator_address host:port --num_processes N --process_id p``
  (or the environment, ``uc2_torch.parallel.multihost``), over
  ``--dist_backend`` (NCCL on CUDA, gloo on the CPU by default). Each
  process trains on its stripe of every training text database, process
  0's bucket choice keeps the shapes in step (``MetaLoader``'s
  ``sync_buckets``), the gradients are summed once a step and the losses
  divided by the global counts (``training/step.py``); ``--zero1`` shards
  the optimizer's moments. Dropout seeds fold in the process index
  (process 0 keeps the one-process seeds). Validation runs whole on
  every process; examples are counted over all of them; process 0 writes
  the logs, milestones and ``restore.ckpt``, every process its stream
  file.

Every task of the reference runs: mlm, tlm, tlm-ni, vmlm, mmxlm,
vmlm-soft, mmxlm-soft (with a spec's ``img_token_soft_label`` stores when
given), mrfr, mrm-nce, mrc, mrc-kl, itm and itm-ot (``--itm_ot_lambda``,
``--ot_pos_only``), with ``--itm_hard_neg`` and ``--optim
adam|adamax|adamw``. Raising by name, for what is not ported yet:
``--n_model > 1`` (tensor parallelism). ``--rng_impl`` and
``--split_step`` choose XLA programs in the reference; here they change
nothing (one log line says so).
``--async_ckpt`` writes milestones from a background thread.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import types
from collections import defaultdict, deque
from typing import Any, Dict

import numpy as np
import torch

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config, parse_with_config
from uc2_torch.parallel import multihost as MH
from uc2_torch.utils.logger import (LOGGER, TB_LOGGER, RunningMeter,
                                    close_run_logs, open_run_logs)


def build_datasets(opts, which: str = "train", shard=None):
    """The task datasets of the config's ``{which}_datasets`` specs:
    {"{task}_{name}[_{i}]": {"dataset", "ratio", "task"}} and the label
    vocabulary (None without a vmlm, mmxlm or soft task). A spec's
    ``img_token_soft_label`` (one store per text database) gives the soft
    tasks their precomputed targets. ``shard=(rank, world)`` stripes each
    text database's ids."""
    from uc2_torch.data import datasets as D
    from uc2_torch.data.db import ImageDbGroup, SoftLabelDb, TxtTokDb
    from uc2_torch.data.labels import LabelVocab

    specs = getattr(opts, f"{which}_datasets")
    img_group = ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb,
                             opts.num_bb)
    label_vocab = None
    out: Dict[str, Any] = {}
    for spec in specs:
        name = spec["name"]
        lang = spec.get("language", name.split("_")[-1]
                        if "_" in name else "en")
        txt_dbs = spec["db"] if isinstance(spec["db"], list) else [spec["db"]]
        img_dbs = spec["img"] if isinstance(spec["img"], list) \
            else [spec["img"]]
        sl_dbs = spec.get("img_token_soft_label")
        for i, (tpath, ipath) in enumerate(zip(txt_dbs, img_dbs)):
            txt_db = TxtTokDb(tpath, max_txt_len=opts.max_txt_len,
                              shard=shard)
            img_db = img_group[ipath]
            for task, ratio in zip(spec["tasks"], spec["mix_ratio"]):
                key = f"{task}_{name}" + (f"_{i}" if len(txt_dbs) > 1 else "")
                if task in ("vmlm", "mmxlm", "vmlm-soft", "mmxlm-soft") \
                        and label_vocab is None:
                    n_cls = getattr(opts, "label_classes", 1601)
                    if n_cls != 1601:
                        # a reduced detector vocabulary (tests, custom data)
                        label_vocab = LabelVocab(
                            words={"en": [f"class{i}"
                                          for i in range(n_cls - 1)]})
                    else:
                        label_vocab = LabelVocab()
                    if label_vocab.source == "hash":
                        LOGGER.warning(
                            "LabelVocab using hash-fallback token ids (no "
                            "XLM-R tokenizer/assets in this environment)")
                # --no_multilingual_vmlm: targets from the English list
                vm_lang = lang if opts.multilingual_vmlm else "en"
                if task == "mlm":
                    ds = D.MlmDataset(txt_db, img_db, opts.mlm_prob)
                elif task in ("tlm", "tlm-ni") and not opts.co_masking:
                    # without co-masking tlm and tlm-ni are plain MLM over
                    # the bilingual record, as the reference's train branch
                    ds = D.MlmDataset(txt_db, img_db, opts.mlm_prob)
                elif task == "tlm":
                    ds = D.TlmDataset(txt_db, img_db, opts.comasking_mode,
                                      mask_prob=opts.mlm_prob)
                elif task == "tlm-ni":
                    ds = D.TlmDataset(txt_db, img_db, opts.comasking_mode,
                                      text_only=True,
                                      mask_prob=opts.mlm_prob)
                elif task == "vmlm":
                    ds = D.VmlmDataset(txt_db, img_db, opts.mrm_prob,
                                       label_vocab, vm_lang)
                elif task == "mmxlm":
                    ds = D.MmxlmDataset(txt_db, img_db, opts.mrm_prob,
                                        label_vocab, vm_lang)
                elif task in ("vmlm-soft", "mmxlm-soft"):
                    sl = SoftLabelDb(sl_dbs[i]) if sl_dbs else None
                    cls_ = (D.VmlmSoftDataset if task == "vmlm-soft"
                            else D.MmxlmSoftDataset)
                    ds = cls_(txt_db, img_db, opts.mrm_prob, label_vocab,
                              soft_label_db=sl)
                elif task == "mrfr":
                    ds = D.MrfrDataset(txt_db, img_db, opts.mrm_prob)
                elif task == "mrm-nce":
                    ds = D.MrmNceDataset(txt_db, img_db, opts.mrm_prob,
                                         neg_size=opts.nce_neg_size)
                elif task in ("mrc", "mrc-kl"):
                    ds = D.MrcDataset(txt_db, img_db, opts.mrm_prob)
                elif task in ("itm", "itm-ot"):
                    cls_ = (D.ItmHardNegDataset if opts.itm_hard_neg
                            else D.ItmDataset)
                    ds = cls_(txt_db, img_db, opts.itm_neg_prob)
                else:
                    raise ValueError(f"undefined task {task}")
                out[key] = {"dataset": ds, "ratio": ratio, "task": task}
    return out, label_vocab


def refuse_unported(opts):
    """Raise, naming the flag, for what the port cannot do yet."""
    if opts.n_model > 1:
        raise NotImplementedError("uc2_torch: --n_model > 1 (tensor "
                                  "parallelism) is not ported yet")


def step_seed(seed: int, index: int, rank: int = 0) -> int:
    """The dropout seed of step (or micro-step) ``index`` on process
    ``rank``: a pure function of (seed, index, rank), the counterpart of
    the reference's ``fold_in(key(seed + 1), index)``. Process 0 keeps the
    one-process seeds; the others fold their index in, so that the
    processes' rows draw different masks."""
    key = [seed + 1, index] + ([rank] if rank else [])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def main(opts):
    """Train as ``opts`` say; returns a namespace with ``step``, ``model``,
    ``optimizer``, ``losses`` ([(step, task, loss)] of this run), ``logs``
    ([(step, host time, examples)] at each log boundary), ``val`` ({task:
    log} of the last validation), ``save_seconds`` (each restore.ckpt
    save) and ``sustained``."""
    refuse_unported(opts)
    dev = resolve_device(opts.device)
    is_main, multi = MH.start_distributed(opts, dev)
    from uc2_torch.utils.misc import set_random_seed
    set_random_seed(opts.seed)
    handler = open_run_logs(opts, is_main)
    try:
        LOGGER.info("--rng_impl=%s and --split_step=%s choose XLA programs "
                    "in the reference; they change nothing here",
                    opts.rng_impl, opts.split_step)
        return _train(opts, dev, is_main, multi)
    finally:
        close_run_logs(handler)


def _train(opts, dev, is_main, multi):
    from uc2_torch.data.collate import default_buckets
    from uc2_torch.data.loader import (MetaLoader, PrefetchLoader,
                                       TaskLoader, task_batch_to_device)
    from uc2_torch.models import convert
    from uc2_torch.models.pretraining import UC2ForPretraining
    from uc2_torch.ops.dropout import DropoutRng
    from uc2_torch.parallel import mesh as M
    from uc2_torch.training import optim as O
    from uc2_torch.training import step as S
    from uc2_torch.training.checkpoint import (AsyncModelSaver, ModelSaver,
                                               TrainingRestorer)
    from uc2_torch.utils.misc import set_dropout

    rank, world = MH.process_index(), MH.process_count()

    # ---- model
    cfg = UC2Config.from_json_file(opts.model_config).replace(
        dtype=opts.dtype)
    if opts.dropout is not None:
        cfg = set_dropout(cfg, opts.dropout)
    model = UC2ForPretraining(cfg, lm_ce_chunks=opts.lm_ce_chunks,
                              device=dev, seed=opts.seed,
                              nce_temp=opts.nce_temp,
                              ot_pos_only=opts.ot_pos_only)
    if opts.checkpoint:
        LOGGER.info("loading checkpoint %s", opts.checkpoint)
        convert.load_partial_tree(model, load_any_checkpoint(
            opts.checkpoint, opts))
    if opts.early_adaptation_checkpoint:
        convert.load_params(model, convert.splice_early_adaptation(
            convert.params_to_jax(model.state_dict()),
            load_raw_checkpoint(opts.early_adaptation_checkpoint)))
    M.broadcast_params(model)

    # ---- data: the training databases striped over the processes;
    # validation whole on each (every process computes the same logs)
    train, label_vocab = build_datasets(
        opts, "train", shard=(rank, world) if multi else None)
    val, _ = (build_datasets(opts, "val") if opts.val_datasets
              else ({}, None))
    valid_ids = label_vocab.valid_ids if label_vocab is not None else None
    loss_kw = dict(valid_ids=valid_ids, itm_ot_lambda=opts.itm_ot_lambda,
                   ot_pos_only=opts.ot_pos_only)
    buckets = default_buckets(opts.max_txt_len, opts.max_bb,
                              opts.train_batch_size)
    loaders = {k: TaskLoader(k, v["dataset"], buckets, seed=opts.seed)
               for k, v in train.items()}
    ratios = {k: v["ratio"] for k, v in train.items()}
    accum = max(1, opts.gradient_accumulation_steps)
    # the step's micro-batches stacked on a leading axis (one bucket a
    # step); --host_accum takes them one by one (buckets may differ)
    stack = accum > 1 and not opts.host_accum
    meta = MetaLoader(loaders, ratios, accum_steps=accum, seed=opts.seed,
                      stack_microbatches=stack, sync_buckets=multi)

    # ---- optimizer and restore
    lr_fn = O.get_lr_schedule(opts.decay, opts.learning_rate,
                              opts.warmup_steps, opts.num_train_steps)
    opt = O.build_optimizer(model, lr_fn, opts.weight_decay,
                            tuple(opts.betas), grad_norm=opts.grad_norm,
                            optim=opts.optim, zero1=opts.zero1)
    # num_train_steps stays out of the check so that a run can be extended
    restorer = TrainingRestorer(
        opts.output_dir, {k: vars(opts)[k] for k in
                          ("learning_rate", "seed", "train_batch_size")},
        save_steps=opts.save_steps, write=is_main)
    MH.check_restore_agrees(restorer.restore_pending)
    global_step = 0
    if restorer.restore_pending:
        global_step = restorer.restore(model, opt)
        LOGGER.info("restored training at step %d", global_step)
        sd = restorer.restore_stream(global_step)
        if multi and not all(MH.all_gather_object(sd is not None)):
            # all or none: processes fed from streams of different
            # positions would train on what an uninterrupted run never saw
            sd = None
        if sd is not None:
            meta.load_state_dict(sd)
            LOGGER.info("restored input-stream state (meta step %d)",
                        meta.step)
        elif not multi:
            meta.fast_forward(global_step)
        else:
            LOGGER.warning("no stream state of step %d on every process: "
                           "the input stream restarts", global_step)

    # the worker starts only now, so it cannot consume stream state that
    # the restore above had to replay; meta_src stays the raw MetaLoader,
    # whose per-step snapshots the restorer saves
    put = task_batch_to_device(dev)
    meta_src = meta
    if not opts.no_prefetch:
        meta = PrefetchLoader(meta, depth=2, device_put=put)
    saver = (AsyncModelSaver if opts.async_ckpt else ModelSaver)(
        opts.output_dir)

    def milestone(step):
        if is_main:
            saver.save(model, step)

    task2loss = defaultdict(lambda: RunningMeter("loss"))
    n_examples = defaultdict(int)
    run = types.SimpleNamespace(step=global_step, model=model, optimizer=opt,
                                losses=[], logs=[], val={}, sustained={},
                                save_seconds=restorer.save_seconds)
    pending = deque()          # (step, task, loss as a device tensor)

    def drain(k=0):
        while len(pending) > k:
            st, nm, lv = pending.popleft()
            v = float(lv)
            task2loss[nm](v)
            run.losses.append((st, nm, v))
            TB_LOGGER.add_scalar(f"step_loss/{nm}", v, st)

    def next_batch():
        name, batch = next(meta)
        return (name, batch) if not opts.no_prefetch else put((name, batch))

    start = time.time()
    sus_step = sus_t = sus_ex = None
    start_step = global_step
    LOGGER.info("start training at step %d over %d tasks", global_step,
                len(loaders))
    try:
        while global_step < opts.num_train_steps:
            if accum == 1 or stack:
                name, batch = next_batch()
                # every process's batch has this bucket's shape
                bs = batch["input_ids"].shape
                n_examples[name] += world * (bs[0] * bs[1] if stack
                                             else bs[0])
                rng = DropoutRng(step_seed(opts.seed, global_step, rank),
                                 dev)
                metrics = S.train_step(model, opt, batch, rng, task=name,
                                       **loss_kw)
            else:
                micro = []
                for k in range(accum):
                    name, batch = next_batch()
                    n_examples[name] += world * batch["input_ids"].shape[0]
                    micro.append((batch, DropoutRng(step_seed(
                        opts.seed, global_step * accum + k, rank), dev)))
                metrics = S.train_step_micro(model, opt, micro, task=name,
                                             **loss_kw)
            global_step += 1
            pending.append((global_step, name, metrics["loss"]))
            drain(opts.runahead)

            if global_step % opts.log_steps == 0:
                drain()            # a full sync: the time below is honest
                TB_LOGGER.add_scalar("lr", float(lr_fn(global_step)),
                                     global_step)
                for t, m in task2loss.items():
                    if m.val is not None:
                        TB_LOGGER.add_scalar(f"loss/{t}", m.val, global_step)
                now = time.time()
                tot = sum(n_examples.values())
                run.logs.append((global_step, now, tot))
                LOGGER.info("step %d | %.0f ex/s | %s", global_step,
                            tot / max(now - start, 1e-9),
                            {t: round(m.val, 4) for t, m in task2loss.items()
                             if m.val is not None})
                TB_LOGGER.add_scalar("perf/ex_per_s",
                                     tot / max(now - start, 1e-9),
                                     global_step)
                # sustained rate between log boundaries after the warm-up
                if sus_step is None:
                    if global_step >= start_step + opts.perf_warmup_steps:
                        sus_step, sus_t, sus_ex = global_step, now, tot
                elif global_step > sus_step:
                    run.sustained = {
                        "ex_per_s": (tot - sus_ex) / (now - sus_t),
                        "steps_per_s": (global_step - sus_step)
                        / (now - sus_t),
                        "window": (sus_step, global_step)}
                    LOGGER.info(
                        "sustained %.1f ex/s | %.2f steps/s (steps %d-%d)",
                        run.sustained["ex_per_s"],
                        run.sustained["steps_per_s"], sus_step, global_step)
                    TB_LOGGER.add_scalar("perf/sustained_ex_per_s",
                                         run.sustained["ex_per_s"],
                                         global_step)
                TB_LOGGER.flush()

            if opts.valid_steps and global_step % opts.valid_steps == 0:
                drain()
                run.val = validate(model, val, buckets, opts, put, valid_ids)
                milestone(global_step)
            # every process: a ZeRO-1 optimizer gathers its moments here
            restorer.step(global_step, model, opt,
                          stream=meta_src.snapshot_for(
                              global_step * meta_src.accum_steps))

            if opts.stop_after_steps and global_step >= opts.stop_after_steps:
                # a simulated preemption: the schedule still targets
                # num_train_steps, as after a real kill and resume
                LOGGER.info("stop_after_steps=%d reached, stopping early",
                            opts.stop_after_steps)
                break
        drain()
    finally:
        if not opts.no_prefetch:
            meta.close()
    if opts.valid_steps and global_step % opts.valid_steps != 0:
        run.val = validate(model, val, buckets, opts, put, valid_ids)
        milestone(global_step)
    saver.wait()
    if run.sustained:
        LOGGER.info("FINAL sustained %.1f ex/s | %.2f steps/s (steps %d-%d)",
                    run.sustained["ex_per_s"], run.sustained["steps_per_s"],
                    *run.sustained["window"])
    LOGGER.info("training done at step %d", global_step)
    run.step = global_step
    return run


def validate(model, val, buckets, opts, put,
             valid_ids=None) -> Dict[str, Dict]:
    """One sweep over each validation task's database, every example once
    (``--val_batches`` > 0 caps the batches a task); logs and returns
    {task: log}: ``loss`` and ``acc`` per word, feature slot or example,
    mrm-nce's mean ``l2`` and ``cos``, and itm-ot's mean ``ot_pos`` and
    ``ot_neg``, as the reference's ``validate`` logs them."""
    from uc2_torch.data.loader import TaskLoader
    from uc2_torch.training import step as S

    logs = {}
    for key, v in val.items():
        task = v["task"]
        tl = TaskLoader(key, v["dataset"], buckets, seed=0, shuffle=False,
                        drop_last=False)
        agg = defaultdict(float)
        t0 = time.time()
        for n_b, batch in enumerate(tl.one_epoch()):
            if opts.val_batches and n_b >= opts.val_batches:
                break
            _, batch = put((key, batch))
            for k, x in S.eval_step(model, batch, task,
                                    valid_ids=valid_ids).items():
                agg[k] += float(x)
        log = {}
        if agg.get("n_word"):
            log["loss"] = agg["loss"] / agg["n_word"]
            log["acc"] = agg.get("n_correct", 0) / agg["n_word"]
        elif agg.get("n_feat"):
            log["loss"] = agg["loss"] / agg["n_feat"]
            if "n_correct" in agg:
                log["acc"] = agg["n_correct"] / agg["n_feat"]
        elif agg.get("n_ex"):
            log["loss"] = agg["loss"] / agg["n_ex"]
            log["acc"] = agg.get("n_correct", 0) / agg["n_ex"]
        if agg.get("n_feat") and "l2_sum" in agg:
            log["l2"] = agg["l2_sum"] / agg["n_feat"]
            log["cos"] = agg["cos_sum"] / agg["n_feat"]
        if agg.get("n_pos"):
            log["ot_pos"] = agg["ot_pos"] / agg["n_pos"]
        if agg.get("n_neg"):
            log["ot_neg"] = agg["ot_neg"] / agg["n_neg"]
        LOGGER.info("validate %s: %s (%.1fs)", key,
                    {k: round(x, 4) for k, x in log.items()},
                    time.time() - t0)
        TB_LOGGER.log_scalar_dict(log, prefix=f"valid_{key}")
        logs[key] = log
    return logs


def resolve_checkpoint_path(path: str) -> str:
    """A checkpoint file as given; a directory (an output_dir or its
    ``ckpt/``) resolves to its newest ``model_step_{N}.pt`` and raises
    when it has none."""
    if not os.path.isdir(path):
        return path
    ckpt_dir = path
    sub = os.path.join(path, "ckpt")
    if os.path.isdir(sub):
        ckpt_dir = sub
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"model_step_(\d+)\.pt", name)
        if m:
            steps.append((int(m.group(1)), name))
    if not steps:
        raise FileNotFoundError(
            f"--checkpoint {path!r} is a directory with no model_step_*.pt "
            f"milestones in {ckpt_dir!r} (contents: "
            f"{sorted(os.listdir(ckpt_dir))[:8]}); pass a checkpoint file "
            f"or a directory that has completed a save")
    steps.sort()
    resolved = os.path.join(ckpt_dir, steps[-1][1])
    LOGGER.info("checkpoint dir %s -> newest milestone %s", path, resolved)
    return resolved


def load_raw_checkpoint(path: str):
    """A PyTorch state dict (``.pt``, ``.bin``, ``.pth``; a ``state_dict``
    entry is unwrapped). The reference package's flax msgpack files are
    not read by the port."""
    path = resolve_checkpoint_path(path)
    if not path.endswith((".pt", ".bin", ".pth")):
        raise ValueError(f"uc2_torch reads PyTorch checkpoints (.pt, .bin, "
                         f".pth), not {path!r}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


_PORT_KEY = re.compile(r"(^|\.)layer\.\d+\.attention\.qkv\.weight$")


def load_any_checkpoint(path: str, opts):
    """A partial reference parameter tree from a checkpoint: the port's
    own milestones (its key names: the fused ``qkv``) convert directly, a
    UC2 / UNITER / XLM-R state dict through ``torch_to_params`` with the
    partial-loading flags."""
    from uc2_torch.models import convert
    sd = load_raw_checkpoint(path)
    if any(_PORT_KEY.search(k) for k in sd):
        return convert.params_to_jax(sd)
    return convert.torch_to_params(
        sd, load_embedding_only=opts.load_embedding_only,
        load_layer=opts.load_layer)


def build_parser():
    p = argparse.ArgumentParser(description="UC2 pretraining (PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config (CLI flags win)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--model_config", type=str,
                   default="config/uc2-base.json")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--early_adaptation_checkpoint", type=str, default=None)
    p.add_argument("--load_embedding_only", action="store_true")
    p.add_argument("--load_layer", type=int, default=None)
    p.add_argument("--output_dir", type=str, required=False,
                   default="output/pretrain")
    p.add_argument("--train_datasets", type=json.loads, default=None)
    p.add_argument("--val_datasets", type=json.loads, default=None)
    # data
    p.add_argument("--max_txt_len", type=int, default=60)
    p.add_argument("--conf_th", type=float, default=0.2)
    p.add_argument("--max_bb", type=int, default=100)
    p.add_argument("--min_bb", type=int, default=10)
    p.add_argument("--num_bb", type=int, default=36)
    p.add_argument("--mlm_prob", type=float, default=0.15)
    p.add_argument("--mrm_prob", type=float, default=0.15)
    p.add_argument("--itm_neg_prob", type=float, default=0.5)
    p.add_argument("--nce_neg_size", type=int, default=128)
    p.add_argument("--nce_temp", type=float, default=1.0,
                   help="mrm-nce softmax temperature")
    p.add_argument("--label_classes", type=int, default=1601,
                   help="detector label vocabulary size (tests may reduce)")
    p.add_argument("--itm_ot_lambda", type=float, default=0.0)
    p.add_argument("--ot_pos_only", action="store_true")
    p.add_argument("--comasking_mode", type=str, default="random",
                   choices=["random", "full", "mix"],
                   help="tlm co-masking mode")
    p.add_argument("--co_masking", dest="co_masking", action="store_true",
                   default=True, help="co-mask aligned words for tlm")
    p.add_argument("--no_co_masking", dest="co_masking",
                   action="store_false",
                   help="tlm/tlm-ni fall back to plain MLM masking")
    p.add_argument("--itm_hard_neg", action="store_true",
                   help="cross-lingual hard-negative ITM sampling")
    p.add_argument("--multilingual_vmlm", dest="multilingual_vmlm",
                   action="store_true", default=True,
                   help="vmlm targets use the dataset language's label list")
    p.add_argument("--no_multilingual_vmlm", dest="multilingual_vmlm",
                   action="store_false",
                   help="vmlm targets always use the EN label list")
    # training
    p.add_argument("--train_batch_size", type=int, default=10240,
                   help="token budget per bucket batch")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=4e-5)
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--optim", type=str, default="adamw",
                   choices=["adam", "adamax", "adamw"])
    p.add_argument("--dropout", type=float, default=None,
                   help="override every dropout probability")
    p.add_argument("--grad_norm", type=float, default=5.0)
    p.add_argument("--decay", type=str, default="linear")
    p.add_argument("--warmup_steps", type=int, default=10000)
    p.add_argument("--num_train_steps", type=int, default=200000)
    p.add_argument("--valid_steps", type=int, default=5000)
    p.add_argument("--val_batches", type=int, default=0,
                   help="cap validation to N batches per task "
                        "(0 = sweep the full val DB)")
    p.add_argument("--host_accum", action="store_true",
                   help="take the micro-batches of a step one by one "
                        "instead of stacked (buckets may differ)")
    p.add_argument("--no_prefetch", action="store_true",
                   help="assemble and copy batches in the training loop "
                        "instead of a worker thread")
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--log_steps", type=int, default=100)
    p.add_argument("--stop_after_steps", type=int, default=0,
                   help="stop the loop after this many steps WITHOUT "
                        "changing the lr schedule's num_train_steps "
                        "(a simulated preemption; 0 = run to the end)")
    p.add_argument("--runahead", type=int, default=8,
                   help="steps whose losses may stay unread on the device")
    p.add_argument("--perf_warmup_steps", type=int, default=10,
                   help="steps before the sustained-throughput window")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--rng_impl", choices=["threefry2x32", "rbg"],
                   default="rbg",
                   help="the reference's PRNG choice; changes nothing here")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel width (only 1 is ported)")
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer's moments over the processes "
                        "(ZeRO-1)")
    p.add_argument("--lm_ce_chunks", type=int, default=0,
                   help="stream the 250k-vocab MLM CE in N chunks")
    p.add_argument("--async_ckpt", action="store_true",
                   help="write milestones from a background thread")
    p.add_argument("--split_step", action="store_true",
                   help="the reference's two-program step; changes "
                        "nothing here")
    MH.add_dist_flags(p)
    return p


def apply_reference_config_compat(opts, argv=None):
    """Accept the original UC2 config's key names where this driver's
    differ (``co_masking_mode``, ``neg_size``); a CLI flag wins."""
    src = argv if argv is not None else sys.argv[1:]
    overridden = {a[2:].split("=")[0] for a in src if a.startswith("--")}
    for ref_key, our_key in (("co_masking_mode", "comasking_mode"),
                             ("neg_size", "nce_neg_size")):
        v = getattr(opts, ref_key, None)
        if v is not None and our_key not in overridden:
            setattr(opts, our_key, v)
    return opts


if __name__ == "__main__":
    opts = parse_with_config(build_parser())
    apply_reference_config_compat(opts)
    MH.run_cli(main, opts)
