"""NLVR2 finetuning (port of the repository's nlvr2.py).

    python -m uc2_torch.nlvr2 --train_txt_db <txt_db> --train_img_db <img_db>
        --fmt triplet|paired|paired-attn [--pred_csv preds.csv] [flags]

The same flags as ``nlvr2.py``, plus ``--device`` (``cuda`` unless
``cpu`` is asked for). The model config defaults to uniter-base (bert
positions, vocab 30522). The path: a text and an image database (a record
names its two images in ``img_fnames`` and its label in ``target``) ->
``Nlvr2PairedDataset`` ("triplet": both images in one row, joint length
``max_txt_len + 2 + 2 max_bb``) or ``Nlvr2TwoRowDataset`` ("paired",
"paired-attn": two rows an example; ``--train_batch_size`` counts pairs)
-> one ``TaskLoader`` -> ``train_step`` on the mean CE -> a milestone every
``--valid_steps`` (there is no validation, as in nlvr2.py) and
``restore.ckpt`` every ``--save_steps`` -> with ``--pred_csv``, one sweep of
the training data (the ragged tail included) into the official CSV
(``identifier,true|false``) that ``python -m uc2_torch.eval_nlvr2`` scores.
A loaded checkpoint's token-type table grows to three rows
(``expand_type_embeddings``) before it is merged.

Dropout, resume, the loss reads and data parallelism across processes
are those of ``uc2_torch.vqa`` (no ``--zero1``, as ``nlvr2.py`` has none);
the prediction sweep runs whole on every process, over the unstriped
text database, and process 0 writes the CSV. Tensor parallelism
(``--n_model``) and what raises under it, likewise.
"""

from __future__ import annotations

import argparse
import csv
import types

from uc2_torch.config import UC2Config, parse_with_config
from uc2_torch.parallel.multihost import run_cli
from uc2_torch.pretrain import load_any_checkpoint
from uc2_torch.utils.logger import LOGGER, close_run_logs
from uc2_torch import vqa


def main(opts):
    """Finetune as ``opts`` say and write ``--pred_csv``; returns a
    namespace with ``step``, ``model``, ``optimizer``, ``losses``
    ([(step, loss)] of this run), ``logs`` ([(step, host time, rows)] at
    each log boundary) and ``preds`` ({identifier: "true" | "false"}, empty
    without ``--pred_csv``)."""
    dev, handler = vqa.start_run(opts, "nlvr2")
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
    from uc2_torch.models.finetune import UC2ForNlvr2, expand_type_embeddings
    from uc2_torch.parallel import mesh as M
    from uc2_torch.training import optim as O
    from uc2_torch.training.checkpoint import ModelSaver

    cfg = UC2Config.from_json_file(opts.model_config).replace(
        dtype=opts.dtype)
    model = UC2ForNlvr2(cfg, fmt=opts.fmt, device=dev, seed=opts.seed)
    if opts.checkpoint:
        LOGGER.info("loading checkpoint %s", opts.checkpoint)
        convert.load_partial_tree(model, expand_type_embeddings(
            load_any_checkpoint(opts.checkpoint, opts)))

    shard = M.data_shard()
    txt_db = TxtTokDb(opts.train_txt_db, max_txt_len=opts.max_txt_len,
                      shard=shard)
    img_db = DetectFeatDb(opts.train_img_db, opts.conf_th, opts.max_bb,
                          opts.min_bb, opts.num_bb)
    if opts.fmt == "triplet":
        dataset = D.Nlvr2PairedDataset(txt_db, img_db,
                                       use_img_type=opts.use_img_type)
        num_bb = 2 * opts.max_bb
    else:
        dataset = D.Nlvr2TwoRowDataset(txt_db, img_db,
                                       use_img_type=opts.use_img_type)
        num_bb = opts.max_bb
    # examples a batch (pairs of rows in the paired formats), raised until
    # their rows divide the world, as the reference raises them to divide
    # its data axis
    rows_per_ex = 1 if opts.fmt == "triplet" else 2
    world = 1 if shard is None else shard[1]
    n_ex = max(1, opts.train_batch_size)
    while (n_ex * rows_per_ex) % world:
        n_ex += 1
    bucket = BucketSpec(opts.max_txt_len + 2, num_bb, n_ex, 0)
    loader = TaskLoader("nlvr2", dataset, [bucket], seed=opts.seed)

    lr_fn = O.get_lr_schedule(opts.decay, opts.learning_rate,
                              opts.warmup_steps, opts.num_train_steps)
    opt, restorer, step = vqa.optimizer_and_restore(opts, model, lr_fn)
    saver = ModelSaver(opts.output_dir, write=restorer.write)
    run = types.SimpleNamespace(step=step, model=model, optimizer=opt,
                                losses=[], logs=[], preds={})

    def on_valid(step):
        saver.save(model, step)     # every process; process 0 writes

    vqa.train_loop(opts, dev, model, opt, restorer, loader, "nlvr2", run,
                   on_valid)
    if opts.pred_csv:
        # the sweep covers every example on every process: across
        # processes over the whole (unstriped) text database
        pred_ds = dataset if shard is None else type(dataset)(
            TxtTokDb(opts.train_txt_db, max_txt_len=opts.max_txt_len),
            img_db, use_img_type=opts.use_img_type)
        run.preds = predict(model, pred_ds, bucket, dev)
    if opts.pred_csv and restorer.write:
        with open(opts.pred_csv, "w", newline="") as f:
            w = csv.writer(f)
            for k, v in run.preds.items():
                w.writerow([k, v])
        LOGGER.info("wrote %d predictions to %s", len(run.preds),
                    opts.pred_csv)
    LOGGER.info("training done at step %d", run.step)
    return run


def predict(model, dataset, bucket, dev):
    """{identifier: "true" | "false"} over one unshuffled epoch of
    ``dataset`` in ``bucket``'s batches, the ragged tail included: the
    batches' predictions in order, given to ``dataset.ids`` in order."""
    from uc2_torch.data.loader import TaskLoader, task_batch_to_device
    put = task_batch_to_device(dev)
    tl = TaskLoader("nlvr2-eval", dataset, [bucket], seed=0, shuffle=False,
                    drop_last=False)
    ids = list(dataset.ids)
    preds = {}
    for b in tl.one_epoch():
        logits = model.logits(put(("nlvr2", b))[1])
        for p in logits.argmax(-1).tolist():
            if len(preds) < len(ids):
                preds[ids[len(preds)]] = "true" if p == 1 else "false"
    return preds


def build_parser():
    p = argparse.ArgumentParser(description="UC2 NLVR2 finetuning "
                                            "(PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config (CLI flags win)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--model_config", default="config/uniter-base.json")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--load_embedding_only", action="store_true")
    p.add_argument("--load_layer", type=int, default=None)
    p.add_argument("--output_dir", default="output/nlvr2")
    p.add_argument("--train_txt_db")
    p.add_argument("--train_img_db")
    p.add_argument("--fmt", default="triplet",
                   choices=["triplet", "paired", "paired-attn"])
    p.add_argument("--use_img_type", action="store_true", default=True)
    p.add_argument("--pred_csv", default=None)
    p.add_argument("--max_txt_len", type=int, default=60)
    p.add_argument("--conf_th", type=float, default=0.2)
    p.add_argument("--max_bb", type=int, default=100)
    p.add_argument("--min_bb", type=int, default=10)
    p.add_argument("--num_bb", type=int, default=36)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    vqa.add_run_flags(p)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--num_train_steps", type=int, default=8000)
    p.add_argument("--valid_steps", type=int, default=500)
    p.add_argument("--save_steps", type=int, default=200)
    p.add_argument("--log_steps", type=int, default=100)
    vqa.add_tail_flags(p)
    return p


if __name__ == "__main__":
    run_cli(main, parse_with_config(build_parser()))
