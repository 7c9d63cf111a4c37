"""Task datasets of config/uc2_pretrain.json's mix (copies of the classes of
uc2_tpu/data/datasets.py that mlm, tlm, vmlm and itm use): each
builds one example at a time, ``get_example(i, rng)``, with every random
draw taken from the caller's ``np.random.Generator`` in the reference's
order, so the same generator state gives the same examples in both
packages. ``ItmDataset.new_epoch(rng)`` draws the epoch's negatives.

They read a text database with ``ids``, ``id2len``, ``txt2img``, ``db[id]``,
``combine_inputs``, ``cls_``, ``sep``, ``mask`` and ``v_range``, and an
image database with ``name2nbb``, ``db[name] -> (feat, bb7)`` and
``get_dump(name)["soft_labels"]``: ``data/db.py``'s databases over U2S
stores, or ``data/memdb.py``'s in memory. Where the image database has
``prefetch`` (``DetectFeatDb``), ``prefetch(indices)`` reads a batch's
images through the store's thread pool before its examples are built.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from uc2_torch.data import masking
from uc2_torch.data.collate import BucketSpec, collate_batch
from uc2_torch.data.labels import LabelVocab


class VLDataset:
    """Paired text and image-region access."""

    pad_token_id = 1
    # the block the prediction slots cover, which sizes M: 15% masking,
    # so 0.35 x the span covers the binomial tail to ~1e-6
    mask_span: Optional[str] = None  # "txt" | "img" | "joint" | None

    @classmethod
    def slot_budget(cls, txt_len: int, num_bb: int) -> int:
        span = {"txt": txt_len, "img": num_bb,
                "joint": txt_len + num_bb}.get(cls.mask_span, 0)
        if not span:
            return 0
        return max(8, -(-int(span * 0.35) // 8) * 8)

    def __init__(self, txt_db, img_db):
        self.txt_db = txt_db
        self.img_db = img_db
        self.ids = list(txt_db.ids)
        self.txt_lens = [txt_db.id2len[i] for i in self.ids]
        self.txt2img = txt_db.txt2img
        self.lens = [tl + img_db.name2nbb[self.txt2img[i]]
                     for tl, i in zip(self.txt_lens, self.ids)]

    def __len__(self):
        return len(self.ids)

    def _img_feat(self, fname: str):
        feat, bb7 = self.img_db[fname]
        return feat, bb7, feat.shape[0]

    def example_record(self, i: int) -> Dict:
        return self.txt_db[self.ids[i]]

    def batch_fnames(self, indices: Sequence[int]) -> List[str]:
        """The image files a batch of ``indices`` reads."""
        return [self.txt2img[self.ids[i]] for i in indices]

    def prefetch(self, indices: Sequence[int]):
        if hasattr(self.img_db, "prefetch"):
            self.img_db.prefetch(self.batch_fnames(indices))

    def _wrap(self, raw, raw_labels):
        """The masked raw text in CLS ... SEP, which are never slots:
        (ids, txt_labels)."""
        ids = np.concatenate([[self.txt_db.cls_], raw,
                              [self.txt_db.sep]]).astype(np.int64)
        labels = np.concatenate([[-1], raw_labels, [-1]]).astype(np.int64)
        return ids, labels

    def collate(self, examples: List[Dict], spec: BucketSpec):
        return collate_batch(examples, spec, self.pad_token_id)


class MlmDataset(VLDataset):
    """Masked language modelling over caption and image."""

    mask_span = "txt"

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob

    def get_example(self, i: int, rng: np.random.Generator) -> Dict:
        rec = self.example_record(i)
        ids, labels = self._wrap(*masking.mask_tokens(
            np.asarray(rec["input_ids"]), self.txt_db.v_range,
            self.txt_db.mask, rng, self.mask_prob))
        feat, bb7, _ = self._img_feat(rec["img_fname"])
        return {"input_ids": ids, "txt_labels": labels,
                "img_feat": feat, "img_pos_feat": bb7}


class TlmDataset(VLDataset):
    """Translation language modelling with cross-lingual co-masking over
    ``[CLS] lang1 [SEP] [SEP] lang2 [SEP]`` pairs, with the image. Position
    ids start at 2 and restart at every token id 0."""

    mask_span = "txt"

    def __init__(self, txt_db, img_db, comasking_mode: str = "random",
                 mask_prob: float = 0.15):
        super().__init__(txt_db, img_db)
        if comasking_mode not in ("random", "full", "mix"):
            raise ValueError(f"unknown comasking_mode {comasking_mode!r}")
        self.mode = comasking_mode
        self.mask_prob = mask_prob

    def get_example(self, i, rng):
        rec = self.example_record(i)
        if self.mode == "mix" and rng.random() < 0.5:
            raw_ids, raw_labels = masking.mask_tokens(
                np.asarray(rec["input_ids"]), self.txt_db.v_range,
                self.txt_db.mask, rng, self.mask_prob)
        else:
            # 'mix' co-masks with the single-subtoken 'random' variant
            mode = "random" if self.mode == "mix" else self.mode
            raw_ids, raw_labels = masking.comask_tokens(
                rec, self.txt_db.v_range, self.txt_db.mask, rng, mode,
                self.mask_prob)
        ids, labels = self._wrap(raw_ids, raw_labels)
        pos, p = [], 2
        for t in ids.tolist():
            p = 2 if t == 0 else p + 1
            pos.append(p)
        feat, bb7, _ = self._img_feat(rec["img_fname"])
        return {"input_ids": ids, "txt_labels": labels,
                "position_ids": np.asarray(pos, np.int64),
                "img_feat": feat, "img_pos_feat": bb7}


class VmlmDataset(VLDataset):
    """Masked region to token with hard targets: masked regions predict a
    subtoken of their top detector class's word in ``lang``; the caption
    is not masked."""

    mask_span = "img"

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15,
                 label_vocab: Optional[LabelVocab] = None, lang: str = "en"):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob
        self.vocab = label_vocab or LabelVocab()
        self.lang = lang

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        txt_labels = np.full(ids.shape[0], -1, np.int64)
        fname = rec["img_fname"]
        feat, bb7, nbb = self._img_feat(fname)
        soft = self.img_db.get_dump(fname)["soft_labels"]
        img_masks, img_labels = masking.region_mask_with_token_labels(
            rng, nbb, soft, self.vocab, self.lang, self.mask_prob)
        return {"input_ids": ids, "txt_labels": txt_labels,
                "img_feat": feat, "img_pos_feat": bb7,
                "img_masks": img_masks, "img_txt_labels": img_labels}


def sample_negative(rng: np.random.Generator, pool: List, exclude) -> Any:
    while True:
        cand = pool[int(rng.integers(0, len(pool)))]
        if cand not in exclude:
            return cand


class ItmDataset(VLDataset):
    """Image-text matching: each epoch (``new_epoch``) pairs every text
    with its own image (target 1) or, with probability ``neg_sample_p``,
    with another image (target 0)."""

    def __init__(self, txt_db, img_db, neg_sample_p: float = 0.5):
        super().__init__(txt_db, img_db)
        self.neg_sample_p = neg_sample_p
        self.all_imgs = sorted({self.txt2img[i] for i in self.ids})
        self.train_imgs: Optional[List[str]] = None
        self.labels: Optional[np.ndarray] = None

    def new_epoch(self, rng: np.random.Generator):
        self.labels = (rng.random(len(self.ids))
                       >= self.neg_sample_p).astype(np.int32)
        self.train_imgs = []
        lens = []
        for i, id_ in enumerate(self.ids):
            fname = self.txt2img[id_]
            if self.labels[i] == 0:
                fname = sample_negative(rng, self.all_imgs, [fname])
            self.train_imgs.append(fname)
            lens.append(self.txt_lens[i] + self.img_db.name2nbb[fname])
        self.lens = lens

    def batch_fnames(self, indices):
        if self.train_imgs is None:
            return super().batch_fnames(indices)
        return [self.train_imgs[i] for i in indices]

    def get_example(self, i, rng):
        if self.train_imgs is None:
            raise RuntimeError("ItmDataset: call new_epoch(rng) first")
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        feat, bb7, _ = self._img_feat(self.train_imgs[i])
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "target": int(self.labels[i])}


def batches(ds: VLDataset, spec: BucketSpec, indices: Sequence[int],
            rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """Collated batches of ``spec.batch_size`` examples over ``indices``
    in order (a trailing partial batch is padded)."""
    B = spec.batch_size
    return [ds.collate([ds.get_example(i, rng) for i in indices[s:s + B]],
                       spec) for s in range(0, len(indices), B)]
