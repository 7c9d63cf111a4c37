"""Real-checkpoint runbook (port of the repository's
scripts/verify_real_ckpt.py): one command from a released UC2 PyTorch
checkpoint and the release's LMDB databases to R@K and logit parity.

    python -m uc2_torch.verify_real_ckpt --checkpoint uc2_mscoco_itm.pt \\
        --txt_db /path/coco_txt_db --img_db /path/coco_img_db \\
        [--workdir DIR] [--txt_limit N] [--quant int8] [--device cpu]

Stages:
  1. import: a database directory holding ``txt.u2s`` / ``feat.u2s`` is
     used as it is; one holding an LMDB environment (``data.mdb``) is
     imported into ``--workdir`` first (``uc2_torch.import_lmdb``, npz
     image values);
  2. load: the state dict through the converter (``normalize_state_dict``,
     ``add_model_prefix``, ``torch_to_params``), or a milestone of the
     port's drivers (its own key names) directly, over the initialised
     ``UC2ForImageTextRetrieval`` of ``--model_config``; the rank head from
     the ITM head's "match" row where the checkpoint has none;
  3. logit parity (not for a milestone of the port's drivers): one batch of the databases scored by the port's model
     as it serves (on the card: the hand kernels, ``--dtype``) and by an
     independent fp32 PyTorch encoder on the CPU that loads the normalized
     state dict by its key names (``uc2_torch/utils/oracle.py``): max and
     mean |difference| and Pearson's correlation of the rank scores;
  4. ``full_retrieval_eval`` over ``--txt_limit`` texts (0: all): R@1/5/10
     in both directions;
  5. with ``--quant int8``, the same eval through the int8 serving
     products and its R@K deltas.

The report is printed as one JSON line and returned. The checkpoint is a
PyTorch state dict (``.pt``, ``.bin``, ``.pth``) under the original UC2
key names or a milestone of the port's drivers (``python -m
uc2_torch.export_uc2`` writes the former from the latter): the reference
package's flax msgpack files raise. ``--dtype`` defaults to bfloat16, the serving
precision of the hand kernels (the reference's default is float32);
parity comes from the fp32 encoder beside it. ``--device cpu`` runs the
plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from uc2_torch import import_lmdb, resolve_device


def _import_if_lmdb(kind: str, src: str, workdir: str) -> str:
    """A U2S database directory for ``src``, importing an LMDB environment
    into ``workdir`` where ``src`` holds one."""
    fname = "txt.u2s" if kind == "txt" else "feat.u2s"
    if os.path.exists(os.path.join(src, fname)):
        return src
    if not os.path.exists(os.path.join(src, "data.mdb")):
        raise FileNotFoundError(
            f"{src}: neither a u2s store ({fname}) nor an LMDB env (data.mdb)")
    dst = os.path.join(workdir, f"{kind}_db")
    if kind == "txt":
        import_lmdb.import_txt(src, dst)
    else:
        import_lmdb.import_img(src, dst, npz=True)
    print(f"[verify] imported LMDB {src} -> {dst}")
    return dst


def _parity_batch(txt_db, img_db, cfg, max_txt_len, num_bb, B):
    """One batch of the databases ([CLS] ids [SEP] | region features), in
    the reference's layout."""
    Lt = max_txt_len + 2
    ids_arr = np.full((B, Lt), cfg.pad_token_id, np.int64)
    feats = np.zeros((B, num_bb, cfg.img_dim), np.float32)
    pos7 = np.zeros((B, num_bb, 7), np.float32)
    mask = np.zeros((B, Lt + num_bb), np.int64)
    tids = list(txt_db.ids)[:B]
    for b, tid in enumerate(tids):
        rec = txt_db[tid]
        ids = np.asarray(txt_db.combine_inputs(rec["input_ids"]))[:Lt]
        ids_arr[b, :len(ids)] = ids
        mask[b, :len(ids)] = 1
        img_feats, img_bb7 = img_db[txt_db.txt2img[tid]]
        nb = min(img_feats.shape[0], num_bb)
        feats[b, :nb] = img_feats[:nb]
        pos7[b, :nb] = img_bb7[:nb]
        mask[b, Lt:Lt + nb] = 1
    return ids_arr, feats, pos7, mask


def count_leaves(tree) -> int:
    """The arrays of a nested parameter tree."""
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1


def _torch_parity(sd_norm, model, cfg, batch, dev):
    """Rank-score parity: the port's model against the fp32 oracle loaded
    with the same normalized state dict (on the CPU)."""
    from uc2_torch.utils.oracle import OracleUC2

    ids, feats, pos7, mask = batch
    oracle = OracleUC2(
        vocab=cfg.vocab_size, h=cfg.hidden_size,
        n_layers=cfg.num_hidden_layers, n_heads=cfg.num_attention_heads,
        ffn=cfg.intermediate_size, max_pos=cfg.max_position_embeddings,
        img_dim=cfg.img_dim, img_label_dim=cfg.img_label_dim,
        pad=cfg.pad_token_id, num_answer=1)
    own = oracle.state_dict()
    want = {k: torch.tensor(np.asarray(v, np.float32))
            for k, v in sd_norm.items()
            if k in own and tuple(own[k].shape) == tuple(
                np.asarray(v).shape)}
    missing = sorted(set(own) - set(want))
    unexpected = sorted(set(sd_norm) - set(want))
    oracle.load_state_dict(want, strict=False)
    # rank head: the model's (from the ITM head) where the checkpoint has
    # none
    if any("rank_output" in m for m in missing):
        with torch.no_grad():
            oracle.rank_output.weight.copy_(model.rank_output.out.weight)
            oracle.rank_output.bias.copy_(model.rank_output.out.bias)
    with torch.no_grad():
        t_scores = oracle.rank_scores(
            torch.tensor(ids), torch.tensor(feats), torch.tensor(pos7),
            torch.tensor(mask)).numpy()
    del oracle
    on = {"input_ids": ids, "img_feat": feats, "img_pos_feat": pos7,
          "attn_mask": mask}
    p_scores = model.scores({k: torch.from_numpy(v).to(dev)
                             for k, v in on.items()}).float().cpu().numpy()
    d = np.abs(p_scores - t_scores)
    corr = float(np.corrcoef(p_scores, t_scores)[0, 1]) \
        if len(p_scores) > 1 else 1.0
    return {"logit_max_abs_diff": float(d.max()),
            "logit_mean_abs_diff": float(d.mean()),
            "logit_pearson": corr,
            "oracle_missing_keys": sorted(missing),
            "oracle_unexpected_keys": sorted(unexpected)[:20]}


def build_parser():
    ap = argparse.ArgumentParser(
        description="UC2 real-checkpoint parity runbook (PyTorch/CUDA)")
    ap.add_argument("--checkpoint", required=True,
                    help=".pt/.bin/.pth under the UC2 release's key names")
    ap.add_argument("--txt_db", required=True,
                    help="LMDB dir of the release or a u2s dir")
    ap.add_argument("--img_db", required=True)
    ap.add_argument("--model_config", default="config/uc2-base.json")
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "uc2_verify"),
                    help="where imported LMDB databases are written")
    ap.add_argument("--max_txt_len", type=int, default=60)
    ap.add_argument("--conf_th", type=float, default=0.2)
    ap.add_argument("--max_bb", type=int, default=100)
    ap.add_argument("--min_bb", type=int, default=10)
    ap.add_argument("--num_bb", type=int, default=36)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--txt_limit", type=int, default=0,
                    help="cap eval texts for a quick smoke (0 = all)")
    ap.add_argument("--parity_batch", type=int, default=8)
    ap.add_argument("--skip_torch", action="store_true",
                    help="skip the logit parity stage")
    ap.add_argument("--dtype", default="bfloat16",
                    help="activation dtype of the port's model (bfloat16 "
                         "serves through the hand kernels; float32 for "
                         "parity on the CPU)")
    ap.add_argument("--quant", choices=["none", "int8"], default="none",
                    help="ALSO run the eval with int8 serving quantization "
                         "and report the R@K deltas vs the unquantized run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from uc2_torch.config import UC2Config
    from uc2_torch.data.db import DetectFeatDb, TxtTokDb
    from uc2_torch.evalu.retrieval import full_retrieval_eval
    from uc2_torch.models import convert
    from uc2_torch.models.finetune import UC2ForImageTextRetrieval
    from uc2_torch.pretrain import is_port_state_dict, load_raw_checkpoint

    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    txt_dir = _import_if_lmdb("txt", args.txt_db, args.workdir)
    img_dir = _import_if_lmdb("img", args.img_db, args.workdir)

    cfg = UC2Config.from_json_file(args.model_config).replace(
        dtype=args.dtype)
    model = UC2ForImageTextRetrieval(cfg, device=dev, seed=0)

    sd = load_raw_checkpoint(args.checkpoint)
    if is_port_state_dict(sd):
        loaded, sd_norm = convert.params_to_jax(sd), None   # a milestone
    else:
        sd_norm = convert.add_model_prefix(convert.normalize_state_dict(sd))
        loaded = convert.torch_to_params(sd_norm)
    del sd
    convert.load_partial_tree(model, loaded)
    if "rank_output" not in loaded:
        convert.init_rank_from_itm(model)
        print("[verify] rank head initialized from pretrained ITM head")

    txt_db = TxtTokDb(txt_dir, max_txt_len=args.max_txt_len)
    img_db = DetectFeatDb(img_dir, args.conf_th, args.max_bb, args.min_bb,
                          args.num_bb)

    report = {"checkpoint": args.checkpoint,
              "n_loaded_params": count_leaves(loaded)}
    del loaded

    if not args.skip_torch and sd_norm is not None:
        batch = _parity_batch(txt_db, img_db, cfg, args.max_txt_len,
                              args.num_bb, args.parity_batch)
        report.update(_torch_parity(sd_norm, model, cfg, batch, dev))
        print(f"[verify] logit parity: max|Δ|="
              f"{report['logit_max_abs_diff']:.3e} "
              f"mean|Δ|={report['logit_mean_abs_diff']:.3e} "
              f"pearson={report['logit_pearson']:.6f}")
    del sd_norm

    txt_ids = list(txt_db.ids)
    if args.txt_limit:
        txt_ids = txt_ids[:args.txt_limit]
    metrics = full_retrieval_eval(
        model, txt_db, img_db, args.max_txt_len + 2, args.num_bb,
        batch_size=args.batch_size, txt_ids=txt_ids, device=dev)
    report["retrieval"] = {k: round(float(v), 4) for k, v in metrics.items()}
    print("[verify] retrieval:", report["retrieval"])

    if args.quant != "none":
        qmetrics = full_retrieval_eval(
            model.serving(args.quant), txt_db, img_db, args.max_txt_len + 2,
            args.num_bb, batch_size=args.batch_size, txt_ids=txt_ids,
            device=dev)
        report["retrieval_int8"] = {k: round(float(v), 4)
                                    for k, v in qmetrics.items()}
        report["retrieval_int8_delta"] = {
            k: round(float(qmetrics[k]) - float(metrics[k]), 4)
            for k in metrics}
        print("[verify] retrieval int8:", report["retrieval_int8"])
        print("[verify] int8 R@K delta:", report["retrieval_int8_delta"])
    print(json.dumps(report, default=str))
    return report


if __name__ == "__main__":
    main()
