"""Synthetic corpus generator (a copy of uc2_tpu/data/synth.py): writes
text and image U2S databases with the real schema through the port's
``StoreWriter``: XLM-R-style token ids, translation-pair records with word
alignments (the fields tlm's co-masking reads), region features with
detector soft labels, and the sidecar JSONs (id2len, meta, txt2img,
img2txts). The same arguments give the reference's files byte for byte.
``synth_finetune_texts`` (the port's own) rewrites such a text database
for VQA or NLVR2 finetuning.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from uc2_torch.data.store import StoreReader, StoreWriter

# XLM-R special ids; MASK is the last vocab id and v_range the ordinary-token
# span, scaled down automatically for reduced test vocabularies.
CLS, PAD, SEP, UNK = 0, 1, 2, 3


def special_ids(vocab: int = 250002):
    mask = vocab - 1
    return {"CLS": CLS, "SEP": SEP, "MASK": mask, "v_range": (4, mask)}


def synth_corpus(out_dir: str, n_imgs: int = 32, txt_per_img: int = 2,
                 vocab: int = 250002, img_dim: int = 2048,
                 n_classes: int = 1601, min_bb: int = 10, max_bb: int = 100,
                 seed: int = 0, paired: bool = False, langs=("en", "de"),
                 max_words: int = 12, compress: bool = True,
                 soft_label_dim: Optional[int] = None,
                 fname_prefix: str = "coco") -> Dict[str, str]:
    """Writes {out_dir}/txt_db and {out_dir}/img_db (+ optional soft-label db).

    paired=True emits translation-pair records with word2ids/walign fields.
    Returns {"txt_db": ..., "img_db": ...} paths.
    """
    rng = np.random.default_rng(seed)
    sp = special_ids(vocab)
    v_range = sp["v_range"]
    txt_dir = os.path.join(out_dir, "txt_db")
    img_dir = os.path.join(out_dir, "img_db")
    os.makedirs(txt_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    # ---- image db
    fnames = [f"{fname_prefix}_{i:06d}.npz" for i in range(n_imgs)]
    with StoreWriter(os.path.join(img_dir, "feat.u2s"),
                     compress=compress) as w:
        for f in fnames:
            nbb = int(rng.integers(min_bb, max_bb + 1))
            x1y1 = rng.random((nbb, 2), np.float32) * 0.5
            wh = rng.random((nbb, 2), np.float32) * 0.5 + 1e-3
            norm_bb = np.concatenate([x1y1, x1y1 + wh, wh],
                                     axis=1).astype(np.float32)
            soft = rng.dirichlet(np.ones(n_classes) * 0.05,
                                 nbb).astype(np.float32)
            w.put(f, {
                "features": rng.standard_normal(
                    (nbb, img_dim)).astype(np.float16),
                "norm_bb": norm_bb,
                "conf": rng.random(nbb).astype(np.float32),
                "soft_labels": soft,
            })
        w.put("__keys__", fnames)

    # ---- text db
    id2len = {}
    txt2img = {}
    img2txts = {f: [] for f in fnames}
    with StoreWriter(os.path.join(txt_dir, "txt.u2s"),
                     compress=compress) as w:
        tid = 0
        for f in fnames:
            for _ in range(txt_per_img):
                key = f"txt_{tid:07d}"
                tid += 1
                n_words = int(rng.integers(3, max_words + 1))
                rec: Dict = {"img_fname": f}
                if not paired:
                    # raw caption token ids (CLS/SEP added by combine_inputs,
                    # reference data/data.py:216-220)
                    raw = rng.integers(*v_range, n_words * 2).tolist()
                else:
                    # language-1/2 word lists with 1-2 subtokens per word
                    def make_lang(n):
                        word2ids, flat = [], []
                        for _ in range(n):
                            k = int(rng.integers(1, 3))
                            word2ids.append(list(range(len(flat),
                                                       len(flat) + k)))
                            flat.extend(rng.integers(*v_range, k).tolist())
                        return word2ids, flat
                    n2 = int(rng.integers(3, max_words + 1))
                    w2i_1, ids1 = make_lang(n_words)
                    w2i_2, ids2 = make_lang(n2)
                    walign = {}
                    for wi in range(n_words):
                        if rng.random() < 0.8:
                            walign[str(wi)] = [int(rng.integers(0, n2))]
                    # paired raw layout: lang1 ⧺ [SEP, SEP] ⧺ lang2 — lang2
                    # token j sits at raw position j + len(lang1) + 2, the
                    # offset the co-masking code uses (data/mlm.py:131,146)
                    raw = ids1 + [SEP, SEP] + ids2
                    rec.update({
                        "input_ids_lang1": ids1,
                        "input_ids_lang2": ids2,
                        "word2ids_lang1": w2i_1,
                        "word2ids_lang2": w2i_2,
                        "lang1_lang2_walign": walign,
                        "langs": list(langs),
                    })
                rec["input_ids"] = raw
                w.put(key, rec)
                id2len[key] = len(raw)
                txt2img[key] = f
                img2txts[f].append(key)

    with open(os.path.join(txt_dir, "id2len.json"), "w") as f:
        json.dump(id2len, f)
    with open(os.path.join(txt_dir, "meta.json"), "w") as f:
        json.dump({"CLS": CLS, "SEP": SEP, "MASK": sp["MASK"],
                   "v_range": list(v_range), "vocab": vocab}, f)
    with open(os.path.join(txt_dir, "txt2img.json"), "w") as f:
        json.dump(txt2img, f)
    with open(os.path.join(txt_dir, "img2txts.json"), "w") as f:
        json.dump(img2txts, f)

    # ---- optional precomputed token soft labels (valid-token space)
    if soft_label_dim:
        sl_dir = os.path.join(out_dir, "soft_label_db")
        os.makedirs(sl_dir, exist_ok=True)
        feat_reader = StoreReader(os.path.join(img_dir, "feat.u2s"))
        with StoreWriter(os.path.join(sl_dir, "soft_labels.u2s"),
                         compress=compress) as w:
            for f in fnames:
                nbb = np.asarray(feat_reader[f]["features"]).shape[0]
                w.put(f, rng.dirichlet(
                    np.ones(soft_label_dim) * 0.1, nbb).astype(np.float32))
        return {"txt_db": txt_dir, "img_db": img_dir, "soft_label_db": sl_dir}

    return {"txt_db": txt_dir, "img_db": img_dir}


def synth_finetune_texts(out_dir: str, src_txt_db: str, task: str,
                         seed: int = 0, num_answer: int = 3129,
                         group: int = 4, compress: bool = True) -> Dict:
    """A text database for VQA or NLVR2 finetuning, written under
    ``out_dir`` from the records of ``src_txt_db`` (``synth_corpus``'s)
    with the fields the task reads:

    * "vqa": ``target`` = {"labels": 1-4 distinct answer ids below
      ``num_answer``, "scores": ``get_score`` of 1-4 annotators each};
    * "nlvr2": ``img_fnames`` = [the record's image, another image of the
      corpus] and ``target`` 0 or 1, under identifiers of NLVR2's
      'split-####-#-#' form that ``group`` records share up to the third
      field (a consistency group); ``annotations.jsonl`` beside the store
      holds each identifier's label ("True" / "False").

    Returns {"txt_db": ...} and, for NLVR2, "annotations"."""
    from uc2_torch.utils.vqa_answers import get_score
    if task not in ("vqa", "nlvr2"):
        raise ValueError(f"unknown finetuning task {task!r}")
    rng = np.random.default_rng(seed)
    reader = StoreReader(os.path.join(src_txt_db, "txt.u2s"))
    with open(os.path.join(src_txt_db, "txt2img.json")) as f:
        src_txt2img = json.load(f)
    with open(os.path.join(src_txt_db, "meta.json")) as f:
        meta = json.load(f)
    imgs = sorted(set(src_txt2img.values()))
    os.makedirs(out_dir, exist_ok=True)
    id2len, txt2img, img2txts, labels = {}, {}, {}, {}
    with StoreWriter(os.path.join(out_dir, "txt.u2s"),
                     compress=compress) as w:
        for i, (tid, img) in enumerate(sorted(src_txt2img.items())):
            rec = dict(reader[tid])
            if task == "vqa":
                k = int(rng.integers(1, min(4, num_answer) + 1))
                rec["target"] = {
                    "labels": rng.choice(num_answer, k,
                                         replace=False).tolist(),
                    "scores": [get_score(int(rng.integers(1, 5)))
                               for _ in range(k)]}
                key = tid
            else:
                other = imgs[(imgs.index(img) + 1 + int(
                    rng.integers(0, len(imgs) - 1))) % len(imgs)]
                rec["img_fnames"] = [img, other]
                rec["target"] = int(rng.integers(0, 2))
                key = f"dev-{i // group:04d}-{i % group}-0"
                labels[key] = "True" if rec["target"] else "False"
            w.put(key, rec)
            id2len[key] = len(rec["input_ids"])
            txt2img[key] = img
            img2txts.setdefault(img, []).append(key)
    for name, obj in (("id2len", id2len), ("txt2img", txt2img),
                      ("img2txts", img2txts), ("meta", meta)):
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    out = {"txt_db": out_dir}
    if task == "nlvr2":
        out["annotations"] = os.path.join(out_dir, "annotations.jsonl")
        with open(out["annotations"], "w") as f:
            for key, lab in labels.items():
                f.write(json.dumps({"identifier": key, "label": lab}) + "\n")
    return out


def reference_lmdb(txt_dir: str, img_dir: str, out_dir: str,
                   npz: bool = True) -> Dict[str, str]:
    """A text and an image store re-encoded in the original UC2 release's
    LMDB layout under ``out_dir`` (``txt_db``, ``img_db``), the input of
    ``python -m uc2_torch.import_lmdb``: text values are LZ4 frames of
    msgpack with the sidecar JSONs; image values are compressed npz
    (fp16 features, fp32 boxes, confidences and soft labels), or
    msgpack-numpy maps with ``npz=False``, plus a JSON ``__keys__``
    record. Written by the port's LMDB writer, LZ4 codec and msgpack
    codec."""
    import io
    import shutil

    from uc2_torch.data import lz4frame
    from uc2_torch.data.lmdbio import LmdbWriter
    from uc2_torch.data.store import pack_value
    lmdb_txt = os.path.join(out_dir, "txt_db")
    lmdb_img = os.path.join(out_dir, "img_db")
    os.makedirs(lmdb_txt, exist_ok=True)
    os.makedirs(lmdb_img, exist_ok=True)
    r = StoreReader(os.path.join(txt_dir, "txt.u2s"), native=False)
    with LmdbWriter(lmdb_txt) as w:
        for key in r.keys():
            w.put(key, lz4frame.compress(pack_value(r[key])))
    for side in ("id2len.json", "meta.json", "txt2img.json",
                 "img2txts.json"):
        shutil.copy(os.path.join(txt_dir, side), os.path.join(lmdb_txt, side))
    ri = StoreReader(os.path.join(img_dir, "feat.u2s"), native=False)
    keys = ri["__keys__"]
    fields = {"features": np.float16, "norm_bb": np.float32,
              "conf": np.float32, "soft_labels": np.float32}
    with LmdbWriter(lmdb_img) as w:
        for fname in keys:
            rec = {f: np.asarray(ri[fname][f], t) for f, t in fields.items()}
            if npz:
                buf = io.BytesIO()
                np.savez_compressed(buf, **rec)
                w.put(fname, buf.getvalue())
            else:
                w.put(fname, pack_value({f: {
                    b"nd": True, b"type": a.dtype.str, b"kind": b"",
                    b"shape": list(a.shape), b"data": a.tobytes()}
                    for f, a in rec.items()}))
        w.put("__keys__", json.dumps(list(keys)).encode("utf-8"))
    return {"txt_db": lmdb_txt, "img_db": lmdb_img}
