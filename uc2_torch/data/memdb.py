"""In-memory text and image databases with the interface that retrieval
scoring and the pretraining datasets read (``uc2_tpu/data/db.py``'s
TxtTokDb and DetectFeatDb), and synthetic corpora drawn from the
distributions of ``uc2_tpu/data/synth.py``: a retrieval gallery
(``synth_gallery``) and a pretraining corpus (``synth_pretrain_corpus``).
The databases over U2S stores on disk are in ``data/db.py``, and
``data/synth.py`` writes such stores.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# XLM-R special ids, as uc2_tpu/data/synth.py
CLS, PAD, SEP = 0, 1, 2


def special_ids(vocab: int = 250002):
    """The mask id (the last id of the vocabulary) and the span of
    ordinary token ids, as the text databases' meta records them."""
    mask = vocab - 1
    return {"CLS": CLS, "SEP": SEP, "MASK": mask, "v_range": (4, mask)}


class MemTxtDb:
    """Tokenized texts: ``ids``, ``id2len``, ``db[id] -> {"input_ids",
    "img_fname", ...}``, ``combine_inputs``, ``txt2img``, ``img2txts`` and
    the meta fields ``cls_``, ``sep``, ``mask`` and ``v_range``.

    As the reference's TxtTokDb, ``ids`` holds only the texts of at most
    ``max_txt_len`` tokens (-1: all); longer ones are dropped, not
    truncated, while ``id2len``, ``txt2img`` and ``img2txts`` keep every
    record."""

    def __init__(self, records: Dict[str, Dict], cls_: int = CLS,
                 sep: int = SEP, vocab: int = 250002, max_txt_len: int = -1):
        self.records = records
        self.id2len = {t: len(r["input_ids"]) for t, r in records.items()}
        self.ids: List[str] = [t for t, n in self.id2len.items()
                               if max_txt_len == -1 or n <= max_txt_len]
        self.cls_ = cls_
        self.sep = sep
        meta = special_ids(vocab)
        self.mask, self.v_range = meta["MASK"], meta["v_range"]
        self.txt2img: Dict[str, str] = {
            t: r["img_fname"] for t, r in records.items()}
        self.img2txts: Dict[str, List[str]] = {}
        for t, im in self.txt2img.items():
            self.img2txts.setdefault(im, []).append(t)

    def __getitem__(self, id_: str) -> Dict:
        return self.records[id_]

    def combine_inputs(self, *inputs: Sequence[int]) -> np.ndarray:
        """[CLS] ids [SEP] (ids [SEP])*"""
        out = [self.cls_]
        for ids in inputs:
            out.extend(list(ids) + [self.sep])
        return np.asarray(out, np.int64)


class MemImgDb:
    """Region features: ``db[name] -> (feat [nbb, D], bb7 [nbb, 7])``,
    ``name2nbb`` and, with ``soft_labels``, ``get_dump(name)["soft_labels"]``
    (the detector's [nbb, classes] distributions, fp32)."""

    def __init__(self, feats: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 soft_labels: Optional[Dict[str, np.ndarray]] = None):
        self.feats = feats
        self.soft_labels = soft_labels or {}
        self.name2nbb = {k: int(f.shape[0]) for k, (f, _) in feats.items()}

    def __getitem__(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        return self.feats[name]

    def get_dump(self, name: str) -> Dict[str, np.ndarray]:
        return {"soft_labels": self.soft_labels[name]}


def synth_gallery(seed: int, n_imgs: int, txt_per_img: int,
                  vocab: int = 250002, img_dim: int = 2048,
                  min_bb: int = 10, max_bb: int = 100,
                  max_words: int = 12) -> Tuple[MemTxtDb, MemImgDb]:
    """A gallery of ``n_imgs`` images with ``txt_per_img`` captions each.

    Region counts are uniform in [min_bb, max_bb]; features are fp16
    standard normals; boxes are [x1, y1, x2, y2, w, h] with corners in
    [0, 0.5) and sides in [1e-3, 0.5 + 1e-3), plus w*h as the seventh
    column; captions are 2*n_words ordinary token ids, n_words uniform in
    [3, max_words]."""
    rng = np.random.default_rng(seed)
    v_range = (4, vocab - 1)
    feats = {}
    records = {}
    for i in range(n_imgs):
        name = f"coco_{i:06d}.npz"
        nbb = int(rng.integers(min_bb, max_bb + 1))
        bb7 = _bb7(_boxes(rng, nbb))
        feats[name] = (rng.standard_normal((nbb, img_dim)).astype(np.float16),
                       bb7)
        for _ in range(txt_per_img):
            n_words = int(rng.integers(3, max_words + 1))
            records[f"txt_{len(records):07d}"] = {
                "img_fname": name,
                "input_ids": rng.integers(*v_range, n_words * 2).tolist()}
    return MemTxtDb(records, vocab=vocab), MemImgDb(feats)


def _boxes(rng, nbb):
    """[x1, y1, x2, y2, w, h] boxes: corners in [0, 0.5), sides in
    [1e-3, 0.5 + 1e-3)."""
    x1y1 = rng.random((nbb, 2), np.float32) * 0.5
    wh = rng.random((nbb, 2), np.float32) * 0.5 + 1e-3
    return np.concatenate([x1y1, x1y1 + wh, wh], axis=1).astype(np.float32)


def _bb7(bb):
    """The boxes and their areas w * h, [nbb, 7]."""
    return np.concatenate([bb, bb[:, 4:5] * bb[:, 5:6]], axis=1)


def synth_pretrain_corpus(seed: int, n_imgs: int, txt_per_img: int,
                          vocab: int = 250002, img_dim: int = 2048,
                          n_classes: int = 1601, min_bb: int = 10,
                          max_bb: int = 100, max_words: int = 12,
                          max_txt_len: int = -1
                          ) -> Tuple[MemTxtDb, MemImgDb]:
    """A pretraining corpus drawn as uc2_tpu/data/synth.py ``synth_corpus``
    draws one, in the same order from the same seed: per image (named
    ``coco_{i:06d}.npz``) its region count (uniform in [min_bb, max_bb]),
    boxes, detector soft labels (Dirichlet, concentration 0.05 over
    ``n_classes``), fp16 standard-normal features and confidences; then
    ``txt_per_img`` texts per image, each an en-de translation pair (its
    ``paired=True`` records): 3..max_words words per language, 1-2
    subtokens per word, word alignments (each lang1 word aligned with
    probability 0.8 to one lang2 word) and the raw layout lang1 [SEP, SEP]
    lang2, the fields that tlm's co-masking reads. ``max_txt_len`` is the
    text database's length filter (``MemTxtDb``)."""
    rng = np.random.default_rng(seed)
    v_range = special_ids(vocab)["v_range"]
    fnames = [f"coco_{i:06d}.npz" for i in range(n_imgs)]
    feats, soft = {}, {}
    for f in fnames:
        nbb = int(rng.integers(min_bb, max_bb + 1))
        bb7 = _bb7(_boxes(rng, nbb))
        soft[f] = rng.dirichlet(np.ones(n_classes) * 0.05,
                                nbb).astype(np.float32)
        feats[f] = (rng.standard_normal((nbb, img_dim)).astype(np.float16),
                    bb7)
        rng.random(nbb)                          # detector confidences

    def make_lang(n):
        word2ids, flat = [], []
        for _ in range(n):
            k = int(rng.integers(1, 3))
            word2ids.append(list(range(len(flat), len(flat) + k)))
            flat.extend(rng.integers(*v_range, k).tolist())
        return word2ids, flat

    records = {}
    for f in fnames:
        for _ in range(txt_per_img):
            n_words = int(rng.integers(3, max_words + 1))
            n2 = int(rng.integers(3, max_words + 1))
            w2i_1, ids1 = make_lang(n_words)
            w2i_2, ids2 = make_lang(n2)
            walign = {}
            for wi in range(n_words):
                if rng.random() < 0.8:
                    walign[str(wi)] = [int(rng.integers(0, n2))]
            records[f"txt_{len(records):07d}"] = {
                "img_fname": f, "input_ids_lang1": ids1,
                "input_ids_lang2": ids2, "word2ids_lang1": w2i_1,
                "word2ids_lang2": w2i_2, "lang1_lang2_walign": walign,
                "langs": ["en", "de"], "input_ids": ids1 + [SEP, SEP] + ids2}
    return (MemTxtDb(records, vocab=vocab, max_txt_len=max_txt_len),
            MemImgDb(feats, soft))
