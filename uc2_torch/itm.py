"""Image-text retrieval finetuning and evaluation (port of the repository's
itm.py).

    python -m uc2_torch.itm --config config/uc2_mscoco_itm.json [flags]

The same flags and config JSONs as ``itm.py`` (CLI wins over the JSON;
the original UC2 config's key names are mapped by
``apply_reference_config_compat``), plus ``--device`` (``cuda`` unless
``cpu`` is asked for) and ``--stop_after_steps``. The path: text and image
databases (one pair per ``--train_txt_db`` entry; an image spec may be a
[train2014, val2014] pair, routed by file name) -> rank datasets
(``ItmRankDataset``, or ``ItmRankHardNegDataset`` with
``--hard_neg_size``) -> one ``TaskLoader`` whose batches are groups of
``sample_size`` rows, stacked ``--gradient_accumulation_steps`` deep ->
``train_step`` on the rank loss -> hard-negative mining (before the first
step and every ``--hard_neg_steps``), validation (``quick_validate``, or
``full_retrieval_eval`` with ``--full_val``) and a milestone every
``--valid_steps``, ``restore.ckpt`` every ``--save_steps`` -> the full
evaluation of every ``--test_datasets`` pair into ``test_results.json``.

* Dropout is a pure function of (seed, global step) (``step_seed``, as in
  the pretraining driver); the micro-batches of a step draw from it in
  turn.
* Resume restores the step, the model and the optimizer; the loader starts
  its stream again, as itm.py's does.
* Losses stay device tensors and are read at each log boundary, so the
  host builds the next batch while the card runs the step.
* Data parallel across processes, as in the pretraining driver (its
  docstring): each process trains on its stripe of every training text
  database, the group count is raised until the rows divide the world,
  ``--zero1`` shards the optimizer's moments, each process mines its own
  pools into ``hard_negs_{step}[.db{k}].host{p}.json``, the full
  validation and the tests gather the score matrix from every process's
  stride of the texts (the quick validation runs whole on each), and
  process 0 writes the logs, milestones, ``restore.ckpt`` and
  ``test_results.json``.

``--quant int8`` scores the validation and the tests with the int8
serving products (``UC2ForImageTextRetrieval.serving``: a model over the
training model's parameters); training and mining stay in ``--dtype``, as
in itm.py.

Tensor parallel under ``--n_model T`` as the pretraining driver
(``uc2_torch/parallel/tensor.py``), ``--quant int8``, ``UC2_ATTN_V2`` and
``UC2_FFN_TRAIN=1`` included.
``--rng_impl`` chooses an XLA generator in the reference and changes
nothing here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config, parse_with_config
from uc2_torch.parallel import multihost as MH
from uc2_torch.pretrain import load_any_checkpoint, step_seed
from uc2_torch.utils.logger import (LOGGER, TB_LOGGER, RunningMeter,
                                    close_run_logs, open_run_logs)


def main(opts):
    """Finetune and evaluate as ``opts`` say; returns a namespace with
    ``step``, ``model``, ``optimizer``, ``sample_size``, ``losses``
    ([(step, loss)] of this run), ``logs`` ([(step, host time, examples)]
    at each log boundary), ``val`` ([(step, log)] of each validation),
    ``mined`` ([(step, seconds, files)] of each mining pass) and
    ``results`` ({test name: log})."""
    dev = resolve_device(opts.device)
    is_main, _ = MH.start_distributed(opts, dev)
    from uc2_torch.utils.misc import set_random_seed
    set_random_seed(opts.seed)
    handler = open_run_logs(opts, is_main)
    try:
        LOGGER.info("--rng_impl=%s chooses an XLA generator in the "
                    "reference; it changes nothing here", opts.rng_impl)
        return _train(opts, dev, is_main)
    finally:
        close_run_logs(handler)


def json_list(spec):
    """A flag value that may hold a JSON list, parsed."""
    if isinstance(spec, str) and spec.lstrip().startswith("["):
        return json.loads(spec)
    return spec


def image_db_opener(opts):
    """open(spec): a path -> its ``DetectFeatDb``; a [train_db, val_db]
    pair (a JSON string or a list) -> a ``RoutingImageDb`` that sends
    "train2014" file names to the first and "val2014" ones to the second
    (the COCO-CN texts name images of both splits). Databases are opened
    once a path."""
    from uc2_torch.data.db import ImageDbGroup, RoutingImageDb
    group = ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb, opts.num_bb)

    def open_img_db(spec):
        spec = json_list(spec)
        if isinstance(spec, (list, tuple)):
            if len(spec) != 2:
                raise ValueError(f"a routing image spec is [train_db, "
                                 f"val_db], not {spec!r}")
            return RoutingImageDb({"train2014": group[spec[0]],
                                   "val2014": group[spec[1]]})
        return group[spec]
    return open_img_db


def train_pairs(opts, open_img_db, shard=None):
    """[(TxtTokDb, image db)] of the training databases: one per
    ``--train_txt_db`` entry, with the ``--train_img_db`` entry at the
    same place (a single text database takes the image spec whole);
    ``shard=(rank, world)`` stripes the texts."""
    from uc2_torch.data.db import TxtTokDb
    txt_specs = json_list(opts.train_txt_db)
    if not isinstance(txt_specs, (list, tuple)):
        txt_specs = [txt_specs]
    if len(txt_specs) > 1:
        img_specs = json_list(opts.train_img_db)
        if not (isinstance(img_specs, (list, tuple))
                and len(img_specs) == len(txt_specs)):
            raise ValueError("--train_img_db must list one spec per train "
                             "txt db")
    else:
        img_specs = [opts.train_img_db]
    return [(TxtTokDb(t, max_txt_len=opts.max_txt_len, shard=shard),
             open_img_db(im))
            for t, im in zip(txt_specs, img_specs)]


def _train(opts, dev, is_main):
    from uc2_torch.data import datasets as D
    from uc2_torch.data.collate import BucketSpec
    from uc2_torch.data.db import TxtTokDb
    from uc2_torch.data.loader import TaskLoader, task_batch_to_device
    from uc2_torch.evalu.retrieval import (full_retrieval_eval,
                                           mine_hard_negatives,
                                           quick_validate)
    from uc2_torch.models import convert
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    from uc2_torch.ops.dropout import DropoutRng
    from uc2_torch.parallel import mesh as M
    from uc2_torch.parallel.tensor import place_model
    from uc2_torch.training import optim as O
    from uc2_torch.training import step as S
    from uc2_torch.training.checkpoint import (AsyncModelSaver, ModelSaver,
                                               TrainingRestorer)
    from uc2_torch.utils.misc import set_dropout

    # ---- model
    cfg = UC2Config.from_json_file(opts.model_config).replace(
        dtype=opts.dtype)
    if opts.dropout is not None:
        cfg = set_dropout(cfg, opts.dropout)
    model = UC2ForImageTextRetrieval(cfg, margin=opts.margin, device=dev,
                                     seed=opts.seed)
    if opts.checkpoint:
        LOGGER.info("loading checkpoint %s", opts.checkpoint)
        convert.load_partial_tree(model, load_any_checkpoint(
            opts.checkpoint, opts))
        convert.init_rank_from_itm(model)
    place_model(model)
    # validation and tests score under --quant, over the same parameters
    eval_model = model.serving(opts.quant)
    # the replica (model group) and their number: the data stripe, the
    # dropout seeds, the rows and the mined files
    rank, world = M.data_index(), M.data_count()

    # ---- data
    open_img_db = image_db_opener(opts)
    pairs = train_pairs(opts, open_img_db, shard=M.data_shard())
    if opts.hard_neg_size > 0:
        subs = [D.ItmRankHardNegDataset(t, im, opts.negative_size,
                                        opts.hard_neg_size)
                for t, im in pairs]
    else:
        subs = [D.ItmRankDataset(t, im, opts.negative_size)
                for t, im in pairs]
    dataset = subs[0] if len(subs) == 1 else D.ConcatDataset(subs)
    sample_size = subs[0].sample_size
    # the rows (groups x sample_size) of a process's batch divide the
    # world, as the reference's divide its data axis
    group_count = max(1, opts.train_batch_size // sample_size)
    while (group_count * sample_size) % world and group_count > 1:
        group_count += 1
    loader = TaskLoader("itm-rank", dataset, [BucketSpec(
        opts.max_txt_len + 2, opts.max_bb, group_count, 0)], seed=opts.seed)
    txt_len = opts.max_txt_len + 2
    val_txt_db = (TxtTokDb(opts.val_txt_db, max_txt_len=opts.max_txt_len)
                  if opts.val_txt_db else None)
    val_img_db = open_img_db(opts.val_img_db) if opts.val_img_db else None

    # ---- optimizer and restore
    lr_fn = O.get_lr_schedule(opts.decay, opts.learning_rate,
                              opts.warmup_steps, opts.num_train_steps)
    if opts.separate_lr:
        opt = O.build_xlmr_optimizer(
            model, lr_fn, O.get_lr_schedule(opts.decay, opts.xlmr_lr,
                                            opts.warmup_steps,
                                            opts.num_train_steps),
            opts.weight_decay, tuple(opts.betas), grad_norm=opts.grad_norm,
            load_layer=opts.load_layer, optim=opts.optim, zero1=opts.zero1)
    else:
        opt = O.build_optimizer(model, lr_fn, opts.weight_decay,
                                tuple(opts.betas), grad_norm=opts.grad_norm,
                                optim=opts.optim, zero1=opts.zero1)
    restorer = TrainingRestorer(
        opts.output_dir, {"lr": opts.learning_rate, "seed": opts.seed},
        save_steps=opts.save_steps, write=is_main)
    MH.check_restore_agrees(restorer.restore_pending)
    global_step = 0
    if restorer.restore_pending:
        global_step = restorer.restore(model, opt)
        LOGGER.info("resumed at step %d", global_step)
    saver = (AsyncModelSaver if opts.async_ckpt else ModelSaver)(
        opts.output_dir, write=is_main)

    run = types.SimpleNamespace(step=global_step, model=model, optimizer=opt,
                                sample_size=sample_size, losses=[], logs=[],
                                val=[], mined=[], results={})

    def mine_all(step):
        """Mine each training pair's pools (negatives come from the pair
        an anchor trains against) into hard_negs_{step}[.db{k}].json, with
        ``.host{p}`` across replicas (each mines its own stripe; the
        first process of a model group writes the file)."""
        t0 = time.perf_counter()
        files = []
        for k, ((tdb, idb), sub) in enumerate(zip(pairs, subs)):
            tag = f"hard_negs_{step}" + (f".db{k}" if len(pairs) > 1 else "")
            tag += f".host{rank}" if world > 1 else ""
            files.append(os.path.join(opts.output_dir, tag + ".json"))
            sub.reload_hard_negs(mine_hard_negatives(
                model, tdb, idb, txt_len, opts.max_bb,
                hard_neg_size=opts.hard_neg_pool_size,
                batch_size=opts.eval_batch_size,
                out_path=files[-1] if M.model_index() == 0 else None,
                device=dev))
        run.mined.append((step, time.perf_counter() - t0, files))

    def validate():
        if opts.full_val:
            return full_retrieval_eval(
                eval_model, val_txt_db, val_img_db, txt_len, opts.max_bb,
                batch_size=opts.eval_batch_size,
                txt_ids=(val_txt_db.ids[:opts.eval_txt_limit]
                         if opts.eval_txt_limit else None), device=dev)
        return quick_validate(eval_model, val_txt_db, val_img_db, txt_len,
                              opts.max_bb,
                              n_txts=opts.eval_txt_limit or None,
                              batch_size=opts.eval_batch_size, device=dev)

    if opts.hard_neg_size > 0:
        # the pools are mined before the first step, so that no hard slot
        # trains on the random fallback
        LOGGER.info("initial hard-negative mining")
        mine_all(0)
        if not opts.hard_neg_steps:
            LOGGER.warning("--hard_neg_steps=0: pools mined once at start, "
                           "periodic re-mining disabled")

    put = task_batch_to_device(dev)
    accum = max(1, opts.gradient_accumulation_steps)
    meter = RunningMeter("rank_loss")
    pending = []               # (step, loss as a device tensor)

    def drain():
        for st, lv in pending:
            v = float(lv)
            meter(v)
            run.losses.append((st, v))
        pending.clear()

    start = time.time()
    n_ex = 0
    LOGGER.info("start training at step %d: %d groups of %d a "
                "micro-batch, %d micro-batches a step", global_step,
                group_count, sample_size, accum)
    while global_step < opts.num_train_steps:
        batch = (loader.next_stacked(accum) if accum > 1
                 else loader.next_batch())
        batch.pop("targets", None)
        bs = batch["input_ids"].shape
        n_ex += world * (bs[0] * bs[1] if accum > 1 else bs[0])
        _, batch = put(("itm-rank", batch))
        metrics = S.train_step(model, opt, batch, DropoutRng(
            step_seed(opts.seed, global_step, rank), dev), task="itm-rank",
            sample_size=sample_size)
        global_step += 1
        pending.append((global_step, metrics["loss"]))

        if global_step % opts.log_steps == 0:
            drain()            # a full sync: the time below is honest
            now = time.time()
            run.logs.append((global_step, now, n_ex))
            LOGGER.info("step %d | %.0f ex/s | %s", global_step,
                        n_ex / max(now - start, 1e-9), meter)
            TB_LOGGER.add_scalar("loss/rank", meter.val, global_step)
            TB_LOGGER.add_scalar("lr", float(lr_fn(global_step)),
                                 global_step)

        if opts.valid_steps and global_step % opts.valid_steps == 0 \
                and val_txt_db is not None:
            log = validate()
            run.val.append((global_step, log))
            LOGGER.info("validation R@K: %s",
                        {k: round(v, 4) for k, v in log.items()})
            TB_LOGGER.log_scalar_dict(log, prefix="val")
            saver.save(model, global_step)   # every process: TP gathers

        if (opts.hard_neg_size > 0 and opts.hard_neg_steps
                and global_step % opts.hard_neg_steps == 0):
            LOGGER.info("mining hard negatives at step %d", global_step)
            mine_all(global_step)
        # every process: a ZeRO-1 optimizer gathers its moments here
        restorer.step(global_step, model, opt)

        if opts.stop_after_steps and global_step >= opts.stop_after_steps:
            # a simulated preemption: the schedule still targets
            # num_train_steps, as after a real kill and resume
            LOGGER.info("stop_after_steps=%d reached, stopping early",
                        opts.stop_after_steps)
            break
    drain()
    run.step = global_step

    # ---- the full evaluation of every test pair
    if global_step >= opts.num_train_steps:
        for spec in opts.test_datasets or []:
            name = spec.get("name", spec["db"])
            log = full_retrieval_eval(
                eval_model, TxtTokDb(spec["db"], max_txt_len=opts.max_txt_len),
                open_img_db(spec["img"]), txt_len, opts.max_bb,
                batch_size=opts.eval_batch_size, device=dev)
            LOGGER.info("test [%s]: %s", name,
                        {k: round(v, 4) for k, v in log.items()})
            run.results[name] = log
        if run.results and is_main:
            with open(os.path.join(opts.output_dir, "test_results.json"),
                      "w") as f:
                json.dump(run.results, f, indent=2)
    saver.wait()
    LOGGER.info("training done at step %d", global_step)
    return run


def build_parser():
    p = argparse.ArgumentParser(
        description="UC2 retrieval finetuning (PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config (CLI flags win)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--model_config", default="config/uc2-base.json")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--load_embedding_only", action="store_true")
    p.add_argument("--load_layer", type=int, default=None)
    p.add_argument("--output_dir", default="output/itm")
    p.add_argument("--train_txt_db", type=str, default=None,
                   help="a text db, or a JSON list of them")
    p.add_argument("--train_img_db", type=str, default=None,
                   help="an image db or a [train2014, val2014] pair; with "
                        "several text dbs a JSON list of one spec each")
    p.add_argument("--val_txt_db", type=str, default=None)
    p.add_argument("--val_img_db", type=str, default=None)
    p.add_argument("--test_datasets", type=json.loads, default=None)
    p.add_argument("--max_txt_len", type=int, default=60)
    p.add_argument("--conf_th", type=float, default=0.2)
    p.add_argument("--max_bb", type=int, default=100)
    p.add_argument("--min_bb", type=int, default=10)
    p.add_argument("--num_bb", type=int, default=36)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--negative_size", type=int, default=1)
    p.add_argument("--hard_neg_size", type=int, default=0,
                   help="hard negatives per positive")
    p.add_argument("--hard_neg_pool_size", type=int, default=20,
                   help="mined pool size each hard slot samples from")
    p.add_argument("--hard_neg_steps", type=int, default=0,
                   help="mine every N steps")
    p.add_argument("--train_batch_size", type=int, default=40,
                   help="examples (groups x sample_size) per micro-batch")
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--quant", choices=["none", "int8"], default="none",
                   help="serving quantization for validation and test "
                   "scoring")
    p.add_argument("--eval_txt_limit", type=int, default=0)
    p.add_argument("--full_val", action="store_true",
                   help="full score-matrix validation instead of the "
                        "400-image quick validation")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--separate_lr", action="store_true",
                   help="--xlmr_lr on the text embeddings and the layers "
                        "up to --load_layer")
    p.add_argument("--xlmr_lr", type=float, default=1e-7)
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--optim", type=str, default="adamw",
                   choices=["adam", "adamax", "adamw"])
    p.add_argument("--dropout", type=float, default=None,
                   help="override every dropout probability")
    p.add_argument("--grad_norm", type=float, default=2.0)
    p.add_argument("--decay", default="linear")
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--num_train_steps", type=int, default=50000)
    p.add_argument("--valid_steps", type=int, default=5000)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--log_steps", type=int, default=100)
    p.add_argument("--stop_after_steps", type=int, default=0,
                   help="stop the loop after this many steps WITHOUT "
                        "changing the lr schedule's num_train_steps "
                        "(a simulated preemption; 0 = run to the end)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rng_impl", choices=["threefry2x32", "rbg"],
                   default="rbg",
                   help="the reference's PRNG choice; changes nothing here")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-batches per optimizer step")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel width: processes a model group")
    p.add_argument("--zero1", action="store_true",
                   help="shard the optimizer's moments over the processes "
                        "(ZeRO-1)")
    p.add_argument("--async_ckpt", action="store_true",
                   help="write milestones from a background thread")
    MH.add_dist_flags(p)
    return p


def apply_reference_config_compat(opts, parser=None, argv=None):
    """Accept the original UC2 itm config's key names: plural
    ``train_txt_dbs``/``train_img_dbs``, one-element ``val_txt_db`` and
    ``val_img_db`` lists, ``test_txt_db``/``test_img_db`` (into
    ``--test_datasets``), ``steps_per_hard_neg`` (``--hard_neg_steps``) and
    ``inf_minibatch_size`` (``--eval_batch_size``). A mapped key fills a
    flag only where neither the command line set it nor the JSON moved it
    from its default; a ``train_loss`` other than "rank" raises."""
    src = argv if argv is not None else sys.argv[1:]
    overridden = {a[2:].split("=")[0] for a in src if a.startswith("--")}

    def fill(name, value):
        if name in overridden:
            return
        default = parser.get_default(name) if parser is not None else None
        if getattr(opts, name, None) == default:
            setattr(opts, name, value)

    if getattr(opts, "train_txt_dbs", None) is not None:
        fill("train_txt_db", opts.train_txt_dbs)
    if getattr(opts, "train_img_dbs", None) is not None:
        fill("train_img_db", opts.train_img_dbs)
    # a list-valued val_txt_db marks the reference's form; a list-valued
    # val_img_db alone is a routing spec
    vt = getattr(opts, "val_txt_db", None)
    if isinstance(vt, (list, tuple)):
        if len(vt) > 1:
            LOGGER.warning("val_txt_db lists %d dbs; validating on the "
                           "first (put the rest in --test_datasets)",
                           len(vt))
        opts.val_txt_db = vt[0] if vt else None
        vi = getattr(opts, "val_img_db", None)
        if isinstance(vi, (list, tuple)):
            opts.val_img_db = vi[0] if vi else None
    tt = getattr(opts, "test_txt_db", None)
    if tt and getattr(opts, "test_datasets", None) is None:
        ti = getattr(opts, "test_img_db", None)
        if isinstance(tt, str):
            tt = [tt]
        if isinstance(ti, str) or ti is None:
            ti = [ti] * len(tt)
        opts.test_datasets = [
            {"db": d, "img": im,
             "name": os.path.basename(str(d).rstrip("/"))}
            for d, im in zip(tt, ti)]
    sp = getattr(opts, "steps_per_hard_neg", None)
    if sp is not None and sp > 0:
        fill("hard_neg_steps", sp)
    imb = getattr(opts, "inf_minibatch_size", None)
    if imb:
        fill("eval_batch_size", imb)
    tl = getattr(opts, "train_loss", None)
    if tl not in (None, "rank"):
        raise SystemExit(f"train_loss={tl!r}: only the 'rank' objective is "
                         "supported")
    return opts


if __name__ == "__main__":
    parser = build_parser()
    opts = parse_with_config(parser)
    apply_reference_config_compat(opts, parser)
    MH.run_cli(main, opts)
