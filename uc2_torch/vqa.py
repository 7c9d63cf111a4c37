"""VQA finetuning (port of the repository's vqa.py).

    python -m uc2_torch.vqa --train_txt_db <txt_db> --train_img_db <img_db>
        [--val_txt_db ... --val_img_db ...] [flags]

The same flags as ``vqa.py``, plus ``--device`` (``cuda`` unless ``cpu``
is asked for). The path: a text and an image database -> ``VqaDataset``
(soft targets over ``--num_answer`` answers, by default the size of the
``--ans2label`` map) -> one ``TaskLoader`` of ``--train_batch_size`` rows
at joint length ``max_txt_len + 2 + max_bb`` -> ``train_step`` on the mean
over the rows of the BCE's sum over the answers -> validation (the VQA
soft score over ``--val_batches`` batches of 32) and a milestone every
``--valid_steps``, ``restore.ckpt`` every ``--save_steps``. The learning
rate is ``--decay linear`` (warm-up and linear decay) or ``vqa`` (the
MCAN staircase of ``--warm_int``, ``--decay_int``, ``--decay_st`` and
``--decay_rate``).

* Dropout is a pure function of (seed, global step) (``step_seed``, as in
  the other drivers).
* Resume restores the step, the model and the optimizer; the loader starts
  its stream again, as vqa.py's does.
* Losses stay device tensors and are read at each log boundary, so the
  host builds the next batch while the card runs the step.
* Data parallel across processes, as in the pretraining driver (its
  docstring; no ``--zero1``, as ``vqa.py`` has none): each process trains
  on its stripe of the training texts, its batch rounded down to a
  multiple of the world as the reference rounds it to its data axis; validation runs
  whole on every process; process 0 writes the logs, milestones and
  ``restore.ckpt``.

Raising by name, for what is not ported yet: ``--n_model > 1``.
``--rng_impl`` chooses an XLA generator in the reference and changes
nothing here. ``python -m uc2_torch.ve`` is this driver with three
answers.
"""

from __future__ import annotations

import argparse
import os
import time
import types

import numpy as np
import torch

from uc2_torch import resolve_device
from uc2_torch.config import UC2Config, parse_with_config
from uc2_torch.parallel import multihost as MH
from uc2_torch.pretrain import (load_any_checkpoint, refuse_unported,
                               step_seed)
from uc2_torch.utils.logger import (LOGGER, TB_LOGGER, RunningMeter,
                                    close_run_logs, open_run_logs)


def start_run(opts, name: str):
    """The common start of the finetuning drivers: refuse what is not
    ported, join the process group the flags describe, seed, and on
    process 0 write ``log/hps.json`` and open the scalar log and the log
    file. Returns (device, the log file's handler)."""
    refuse_unported(opts)
    dev = resolve_device(opts.device)
    is_main, _ = MH.start_distributed(opts, dev)
    from uc2_torch.utils.misc import set_random_seed
    set_random_seed(opts.seed)
    handler = open_run_logs(opts, is_main)
    LOGGER.info("%s: --rng_impl=%s chooses an XLA generator in the "
                "reference; it changes nothing here", name, opts.rng_impl)
    return dev, handler



def data_shard():
    """(rank, world) of this process when there are several, else None:
    the training texts' stripe."""
    return ((MH.process_index(), MH.process_count())
            if MH.process_count() > 1 else None)



def train_loop(opts, dev, model, opt, restorer, loader, task, run,
               on_valid):
    """The finetuning drivers' loop from ``run.step`` to
    ``--num_train_steps``: a batch, one ``train_step`` of ``task`` with
    dropout from (seed, step), the loss meter read and logged every
    ``--log_steps`` (``loss/{task}``), ``on_valid(step)`` every
    ``--valid_steps``, ``restore.ckpt`` every ``--save_steps``. Appends
    (step, loss) to ``run.losses`` and (step, host time, rows) to
    ``run.logs``."""
    from uc2_torch.data.loader import task_batch_to_device
    from uc2_torch.ops.dropout import DropoutRng
    from uc2_torch.training import step as S
    put = task_batch_to_device(dev)
    rank, world = MH.process_index(), MH.process_count()
    meter = RunningMeter(f"{task}_loss")
    pending = []               # (step, loss as a device tensor)

    def drain():
        for st, lv in pending:
            v = float(lv)
            meter(v)
            run.losses.append((st, v))
        pending.clear()

    global_step = run.step
    start, n_rows = time.time(), 0
    LOGGER.info("start training at step %d", global_step)
    while global_step < opts.num_train_steps:
        _, batch = put((task, loader.next_batch()))
        n_rows += world * batch["input_ids"].shape[0]
        metrics = S.train_step(model, opt, batch, DropoutRng(
            step_seed(opts.seed, global_step, rank), dev), task=task)
        global_step += 1
        pending.append((global_step, metrics["loss"]))
        if global_step % opts.log_steps == 0:
            drain()            # a full sync: the time below is honest
            now = time.time()
            run.logs.append((global_step, now, n_rows))
            LOGGER.info("step %d | %.0f rows/s | %s", global_step,
                        n_rows / max(now - start, 1e-9), meter)
            TB_LOGGER.add_scalar(f"loss/{task}", meter.val, global_step)
        if opts.valid_steps and global_step % opts.valid_steps == 0:
            on_valid(global_step)
        restorer.step(global_step, model, opt)      # every process
    drain()
    run.step = global_step
    return run


def optimizer_and_restore(opts, model, lr_fn):
    """The optimizer over ``model`` (rank 0's parameters on every
    process) and the restore: returns (optimizer, restorer, the step to
    start from)."""
    from uc2_torch.parallel import mesh as M
    from uc2_torch.training import optim as O
    from uc2_torch.training.checkpoint import TrainingRestorer
    M.broadcast_params(model)
    opt = O.build_optimizer(model, lr_fn, opts.weight_decay,
                            tuple(opts.betas), grad_norm=opts.grad_norm)
    restorer = TrainingRestorer(
        opts.output_dir, {"lr": opts.learning_rate, "seed": opts.seed},
        save_steps=opts.save_steps, write=MH.process_index() == 0)
    MH.check_restore_agrees(restorer.restore_pending)
    step = 0
    if restorer.restore_pending:
        step = restorer.restore(model, opt)
        LOGGER.info("resumed at step %d", step)
    return opt, restorer, step


def main(opts):
    """Finetune as ``opts`` say; returns a namespace with ``step``,
    ``model``, ``optimizer``, ``losses`` ([(step, loss)] of this run),
    ``logs`` ([(step, host time, rows)] at each log boundary) and ``val``
    ([(step, soft score)] of each validation)."""
    dev, handler = start_run(opts, "vqa")
    try:
        return _train(opts, dev)
    finally:
        close_run_logs(handler)


def _train(opts, dev):
    from uc2_torch.data import datasets as D
    from uc2_torch.data.collate import BucketSpec
    from uc2_torch.data.db import DetectFeatDb, TxtTokDb
    from uc2_torch.data.loader import TaskLoader
    from uc2_torch.models import convert
    from uc2_torch.models.finetune import UC2ForVqa
    from uc2_torch.training import optim as O
    from uc2_torch.training.checkpoint import ModelSaver
    from uc2_torch.utils.vqa_answers import load_ans2label

    if opts.num_answer is None:
        opts.num_answer = len(load_ans2label(opts.ans2label))
    cfg = UC2Config.from_json_file(opts.model_config).replace(
        dtype=opts.dtype)
    model = UC2ForVqa(cfg, opts.num_answer, device=dev, seed=opts.seed)
    if opts.checkpoint:
        LOGGER.info("loading checkpoint %s", opts.checkpoint)
        convert.load_partial_tree(model, load_any_checkpoint(
            opts.checkpoint, opts))

    txt_db = TxtTokDb(opts.train_txt_db, max_txt_len=opts.max_txt_len,
                      shard=data_shard())
    img_db = DetectFeatDb(opts.train_img_db, opts.conf_th, opts.max_bb,
                          opts.min_bb, opts.num_bb)
    dataset = D.VqaDataset(txt_db, img_db, num_answers=opts.num_answer)
    # the rows a multiple of the world, rounded down as the reference
    # rounds them to its data axis
    world = MH.process_count()
    loader = TaskLoader("vqa", dataset, [BucketSpec(
        opts.max_txt_len + 2, opts.max_bb,
        max(world, opts.train_batch_size // world * world), 0)],
        seed=opts.seed)

    if opts.decay == "vqa":
        lr_fn = O.vqa_schedule(opts.learning_rate, opts.warm_int,
                               opts.decay_int, opts.decay_st,
                               opts.decay_rate)
    else:
        lr_fn = O.get_lr_schedule(opts.decay, opts.learning_rate,
                                  opts.warmup_steps, opts.num_train_steps)
    opt, restorer, step = optimizer_and_restore(opts, model, lr_fn)
    saver = ModelSaver(opts.output_dir)
    is_main = restorer.write
    run = types.SimpleNamespace(step=step, model=model, optimizer=opt,
                                losses=[], logs=[], val=[])
    val_data = []

    def on_valid(global_step):
        if opts.val_txt_db:
            if not val_data:
                val_data.append(D.VqaDataset(
                    TxtTokDb(opts.val_txt_db, max_txt_len=opts.max_txt_len),
                    DetectFeatDb(opts.val_img_db, opts.conf_th, opts.max_bb,
                                 opts.min_bb, opts.num_bb),
                    num_answers=opts.num_answer))
            run.val.append((global_step, validate(model, val_data[0], opts,
                                                  dev)))
        if is_main:
            saver.save(model, global_step)

    train_loop(opts, dev, model, opt, restorer, loader, "vqa", run, on_valid)
    LOGGER.info("training done at step %d", run.step)
    return run


@torch.no_grad()
def validate(model, ds, opts, dev):
    """The VQA soft score, sum of target[argmax] over the live rows of
    ``--val_batches`` batches of 32 (unshuffled, the ragged tail kept),
    over their count."""
    from uc2_torch.data.collate import BucketSpec
    from uc2_torch.data.loader import TaskLoader, task_batch_to_device
    put = task_batch_to_device(dev)
    tl = TaskLoader("vqa-val", ds, [BucketSpec(opts.max_txt_len + 2,
                                               opts.max_bb, 32, 0)],
                    seed=0, shuffle=False, drop_last=False)
    score = n = 0.0
    for _ in range(opts.val_batches):
        batch = tl.next_batch()
        logits = model.logits(put(("vqa", batch))[1]).cpu().numpy()
        pred = logits.argmax(-1)
        tgt = np.asarray(batch["soft_targets"])
        live = np.asarray(batch["attn_mask"]).sum(-1) > 0
        score += float(tgt[np.arange(len(pred)), pred][live].sum())
        n += float(live.sum())
    acc = score / max(n, 1)
    LOGGER.info("VQA val soft-acc: %.4f over %d", acc, int(n))
    TB_LOGGER.add_scalar("valid/vqa_score", acc)
    return acc


def add_run_flags(p):
    """The flags the finetuning drivers share after their data flags."""
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--grad_norm", type=float, default=2.0)
    p.add_argument("--decay", default="linear")


def add_tail_flags(p):
    """The flags the finetuning drivers end with."""
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--rng_impl", choices=["threefry2x32", "rbg"],
                   default="rbg",
                   help="the reference's PRNG choice; changes nothing here")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel width (only 1 is ported)")
    MH.add_dist_flags(p)


def build_parser():
    p = argparse.ArgumentParser(description="UC2 VQA finetuning "
                                            "(PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config (CLI flags win)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--model_config", default="config/uc2-base.json")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--load_embedding_only", action="store_true")
    p.add_argument("--load_layer", type=int, default=None)
    p.add_argument("--output_dir", default="output/vqa")
    p.add_argument("--train_txt_db")
    p.add_argument("--train_img_db")
    p.add_argument("--val_txt_db", default=None)
    p.add_argument("--val_img_db", default=None)
    p.add_argument("--ans2label", default="ans2label.json",
                   help="asset name (e.g. ans2label_ja.json)")
    p.add_argument("--num_answer", type=int, default=None)
    p.add_argument("--max_txt_len", type=int, default=60)
    p.add_argument("--conf_th", type=float, default=0.2)
    p.add_argument("--max_bb", type=int, default=100)
    p.add_argument("--min_bb", type=int, default=10)
    p.add_argument("--num_bb", type=int, default=36)
    p.add_argument("--train_batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=8e-5)
    add_run_flags(p)
    p.add_argument("--warmup_steps", type=int, default=600)
    p.add_argument("--warm_int", type=int, default=2000)
    p.add_argument("--decay_int", type=int, default=2000)
    p.add_argument("--decay_st", type=int, default=9000)
    p.add_argument("--decay_rate", type=float, default=0.2)
    p.add_argument("--num_train_steps", type=int, default=6000)
    p.add_argument("--valid_steps", type=int, default=500)
    p.add_argument("--val_batches", type=int, default=8)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--log_steps", type=int, default=100)
    add_tail_flags(p)
    return p


if __name__ == "__main__":
    MH.run_cli(main, parse_with_config(build_parser()))
