"""The pretraining tasks' datasets (copies of the classes of
uc2_tpu/data/datasets.py): each builds one example at a time,
``get_example(i, rng)``, with every random draw taken from the caller's
``np.random.Generator`` in the reference's order, so the same generator
state gives the same examples in both packages. ``ItmDataset.new_epoch``
(and ``ItmHardNegDataset``'s) draws the epoch's negatives. The retrieval
finetuning datasets (``ItmRankDataset``, ``ItmRankHardNegDataset``) give
a group of examples, which the loader flattens; ``ConcatDataset`` joins
the datasets of several databases. ``VqaDataset``, ``VeDataset``,
``Nlvr2TwoRowDataset`` (two rows an example) and ``Nlvr2PairedDataset``
(both images in one row) serve the VQA, VE and NLVR2 finetuning.

They read a text database with ``ids``, ``id2len``, ``txt2img``, ``db[id]``,
``combine_inputs``, ``cls_``, ``sep``, ``mask`` and ``v_range``, and an
image database with ``name2nbb``, ``db[name] -> (feat, bb7)`` and
``get_dump(name)["soft_labels"]``: ``data/db.py``'s databases over U2S
stores, or ``data/memdb.py``'s in memory. Where the image database has
``prefetch`` (``DetectFeatDb``), ``prefetch(indices)`` reads a batch's
images through the store's thread pool before its examples are built.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from uc2_torch.data import masking
from uc2_torch.data.collate import BucketSpec, collate_batch
from uc2_torch.data.labels import LabelVocab


class VLDataset:
    """Paired text and image-region access."""

    pad_token_id = 1
    # the per-region (or, ``txt_*``, per-token) targets collate gathers at
    # the prediction slots
    slot_target_keys: Sequence[str] = ()
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

    def __init__(self, txt_db, img_db, ids: Optional[Sequence[str]] = None):
        self.txt_db = txt_db
        self.img_db = img_db
        self.ids = list(txt_db.ids if ids is None else ids)
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
        return collate_batch(examples, spec, self.pad_token_id,
                             self.slot_target_keys)


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
    ``[CLS] lang1 [SEP] [SEP] lang2 [SEP]`` pairs, with the image unless
    ``text_only`` (tlm-ni). Position ids start at 2 and restart at every
    token id 0."""

    mask_span = "txt"

    def __init__(self, txt_db, img_db, comasking_mode: str = "random",
                 text_only: bool = False, mask_prob: float = 0.15):
        super().__init__(txt_db, img_db)
        if comasking_mode not in ("random", "full", "mix"):
            raise ValueError(f"unknown comasking_mode {comasking_mode!r}")
        self.mode = comasking_mode
        self.text_only = text_only
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
        ex = {"input_ids": ids, "txt_labels": labels,
              "position_ids": np.asarray(pos, np.int64)}
        if not self.text_only:
            feat, bb7, _ = self._img_feat(rec["img_fname"])
            ex.update(img_feat=feat, img_pos_feat=bb7)
        return ex


class VmlmDataset(VLDataset):
    """Masked region to token with hard targets: masked regions predict a
    subtoken of their top detector class's word in ``lang``; the caption
    is masked too with ``mask_text`` (mmxlm)."""

    mask_span = "img"

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15,
                 label_vocab: Optional[LabelVocab] = None, lang: str = "en",
                 mask_text: bool = False):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob
        self.vocab = label_vocab or LabelVocab()
        self.lang = lang
        self.mask_text = mask_text

    def _text(self, rec, rng):
        """(ids, txt_labels): the caption masked as mlm masks it with
        ``mask_text``, else whole with no text slot."""
        if self.mask_text:
            return self._wrap(*masking.mask_tokens(
                np.asarray(rec["input_ids"]), self.txt_db.v_range,
                self.txt_db.mask, rng, self.mask_prob))
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        return ids, np.full(ids.shape[0], -1, np.int64)

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids, txt_labels = self._text(rec, rng)
        fname = rec["img_fname"]
        feat, bb7, nbb = self._img_feat(fname)
        soft = self.img_db.get_dump(fname)["soft_labels"]
        img_masks, img_labels = masking.region_mask_with_token_labels(
            rng, nbb, soft, self.vocab, self.lang, self.mask_prob)
        return {"input_ids": ids, "txt_labels": txt_labels,
                "img_feat": feat, "img_pos_feat": bb7,
                "img_masks": img_masks, "img_txt_labels": img_labels}


class MmxlmDataset(VmlmDataset):
    """vmlm with the caption masked too: the slots cover text and
    regions."""

    mask_span = "joint"

    def __init__(self, txt_db, img_db, mask_prob=0.15, label_vocab=None,
                 lang="en"):
        super().__init__(txt_db, img_db, mask_prob, label_vocab, lang,
                         mask_text=True)


class VmlmSoftDataset(VLDataset):
    """Masked region to token with soft targets: a masked region's target
    is its detector distribution projected onto the label-word tokens
    (``valid_ids`` space), or the image's row of a precomputed
    ``SoftLabelDb``. With ``mask_text`` (mmxlm-soft) the caption is masked
    too, each masked token's target a one-hot in that space (all zero for
    a token outside it); collate merges both into ``label_targets``."""

    mask_span = "img"
    slot_target_keys = ("txt_soft_targets", "label_targets")

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15,
                 label_vocab: Optional[LabelVocab] = None,
                 soft_label_db=None, mask_text: bool = False):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob
        self.vocab = label_vocab or LabelVocab()
        self.soft_label_db = soft_label_db
        self.mask_text = mask_text
        self.n_valid = len(self.vocab.valid_ids)

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        fname = rec["img_fname"]
        feat, bb7, nbb = self._img_feat(fname)
        img_masks = masking.region_mask(rng, nbb, self.mask_prob)
        if self.soft_label_db is not None:
            token_soft = self.soft_label_db[fname][:nbb]
        else:
            soft = self.img_db.get_dump(fname)["soft_labels"]
            token_soft = self.vocab.project_soft_labels(soft)
        ex = {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
              "img_masks": img_masks, "label_targets": token_soft}
        if self.mask_text:
            ids2, txt_labels = self._wrap(*masking.mask_tokens(
                np.asarray(rec["input_ids"]), self.txt_db.v_range,
                self.txt_db.mask, rng, self.mask_prob))
            onehot = np.zeros((ids2.shape[0], self.n_valid), np.float32)
            valid = self.vocab.valid_ids
            for p in np.flatnonzero(txt_labels != -1):
                j = np.searchsorted(valid, txt_labels[p])
                if j < self.n_valid and valid[j] == txt_labels[p]:
                    onehot[p, j] = 1.0
            ex.update(input_ids=ids2, txt_labels=txt_labels,
                      txt_soft_targets=onehot)
        return ex

    def collate(self, examples, spec):
        batch = super().collate(examples, spec)
        if "txt_soft_targets" in batch:
            # text slots hold one-hots, region slots projections: one array
            batch["label_targets"] = (batch.pop("txt_soft_targets")
                                      + batch["label_targets"])
        return batch


class MmxlmSoftDataset(VmlmSoftDataset):
    """vmlm-soft with the caption masked too."""

    mask_span = "joint"

    def __init__(self, txt_db, img_db, mask_prob=0.15, label_vocab=None,
                 soft_label_db=None):
        super().__init__(txt_db, img_db, mask_prob, label_vocab,
                         soft_label_db, mask_text=True)


class MrfrDataset(VLDataset):
    """Masked region feature regression: a masked region's target is its
    own feature."""

    mask_span = "img"
    slot_target_keys = ("feat_targets",)

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        feat, bb7, nbb = self._img_feat(rec["img_fname"])
        img_masks = masking.region_mask(rng, nbb, self.mask_prob)
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "img_masks": img_masks, "img_mask_tgt": img_masks,
                "feat_targets": feat.copy()}


class MrcDataset(VLDataset):
    """Masked region classification: a masked region's target is its
    detector distribution (mrc takes its argmax, mrc-kl the whole)."""

    mask_span = "img"
    slot_target_keys = ("label_targets",)

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15):
        super().__init__(txt_db, img_db)
        self.mask_prob = mask_prob

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        fname = rec["img_fname"]
        feat, bb7, nbb = self._img_feat(fname)
        soft = self.img_db.get_dump(fname)["soft_labels"]
        img_masks = masking.region_mask(rng, nbb, self.mask_prob)
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "img_masks": img_masks, "img_mask_tgt": img_masks,
                "label_targets": soft}


class NegativeImageSampler:
    """``neg_size`` region features from random images other than the
    example's own."""

    def __init__(self, img_db, neg_size: int = 128):
        self.img_db = img_db
        self.neg_size = neg_size
        self.fnames = sorted(img_db.name2nbb.keys())

    def sample(self, rng: np.random.Generator, exclude: str) -> np.ndarray:
        out = []
        total = 0
        while total < self.neg_size:
            f = self.fnames[int(rng.integers(0, len(self.fnames)))]
            if f == exclude:
                continue
            feat, _ = self.img_db[f]
            out.append(feat)
            total += feat.shape[0]
        return np.concatenate(out, axis=0)[:self.neg_size]


class MrmNceDataset(MrfrDataset):
    """Masked region contrastive learning: of the masked regions, 10% stay
    visible, 10% take another region's feature and the rest are zeroed;
    every masked region is a slot whose target is its own feature, scored
    against the batch's targets and a shared pool of negative features
    (``neg_feats``: the first example's ``neg_size`` rows, then 8 of each
    other example's)."""

    slot_target_keys = ("feat_targets",)

    def __init__(self, txt_db, img_db, mask_prob: float = 0.15,
                 neg_size: int = 128, noop_prob: float = 0.1,
                 swap_prob: float = 0.1):
        super().__init__(txt_db, img_db, mask_prob)
        self.neg_sampler = NegativeImageSampler(img_db, neg_size)
        self.noop_prob = noop_prob
        self.swap_prob = swap_prob

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        feat, bb7, nbb = self._img_feat(rec["img_fname"])
        img_masks = masking.region_mask(rng, nbb, self.mask_prob)
        u = rng.random(nbb)
        visible = img_masks & (u < self.noop_prob)
        swap = (img_masks & (u >= self.noop_prob)
                & (u < self.noop_prob + self.swap_prob))
        feat_in = feat.copy()
        if swap.any():
            src = rng.integers(0, nbb, int(swap.sum()))
            feat_in[np.flatnonzero(swap)] = feat[src]
        # the model's img_masks are the zeroed regions only; every masked
        # region is a slot (img_mask_tgt)
        return {"input_ids": ids, "img_feat": feat_in, "img_pos_feat": bb7,
                "img_masks": img_masks & ~visible & ~swap,
                "img_mask_tgt": img_masks, "feat_targets": feat.copy(),
                "neg_feats": self.neg_sampler.sample(rng, rec["img_fname"])}

    def collate(self, examples, spec):
        batch = super().collate(examples, spec)
        pools = [e["neg_feats"] for e in examples]
        batch["neg_feats"] = np.concatenate(
            [pools[0]] + [p[:8] for p in pools[1:]], axis=0)
        return batch


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


class ItmHardNegDataset(ItmDataset):
    """Cross-lingual hard negatives over translation-pair records
    (``input_ids_lang1``/``_lang2``): a negative swaps the image (50%),
    the first language's caption (25%) or the second's (25%) for another
    example's. ``new_epoch`` draws the swaps, and each example's
    ``txt_lens`` and ``lens`` follow them: a swapped caption changes the
    text length, a swapped image the region count, and stale lengths
    would send the example to a bucket too small for it, where collate
    cuts the caption's tail."""

    def __init__(self, txt_db, img_db, neg_sample_p: float = 0.5,
                 neg_img: float = 0.5, neg_lang1: float = 0.25,
                 neg_lang2: float = 0.25):
        if abs(neg_img + neg_lang1 + neg_lang2 - 1) >= 1e-6:
            raise ValueError("the negative shares must sum to 1")
        self.neg_split = (neg_img, neg_lang1, neg_lang2)
        super().__init__(txt_db, img_db, neg_sample_p)

    def new_epoch(self, rng):
        self.labels = (rng.random(len(self.ids))
                       >= self.neg_sample_p).astype(np.int32)
        self.train_imgs, self.train_raw_ids = [], []
        txt_lens, lens = [], []
        neg_img, neg_l1, _ = self.neg_split
        for i in range(len(self.ids)):
            rec = self.example_record(i)
            fname = rec["img_fname"]
            raw = list(rec["input_ids"])
            if self.labels[i] == 0:
                u = rng.random()
                if u < neg_img:
                    fname = sample_negative(rng, self.all_imgs, [fname])
                else:
                    lang_key = ("input_ids_lang1" if u < neg_img + neg_l1
                                else "input_ids_lang2")
                    j = int(rng.integers(0, len(self.ids)))
                    other = list(self.example_record(j)[lang_key])
                    l1 = list(rec["input_ids_lang1"])
                    l2 = list(rec["input_ids_lang2"])
                    if lang_key == "input_ids_lang1":
                        l1 = other
                    else:
                        l2 = other
                    sep = self.txt_db.sep
                    raw = l1 + [sep, sep] + l2
            self.train_imgs.append(fname)
            self.train_raw_ids.append(raw)
            txt_lens.append(len(raw))
            lens.append(len(raw) + self.img_db.name2nbb[fname])
        self.txt_lens = txt_lens
        self.lens = lens

    def get_example(self, i, rng):
        if self.train_imgs is None:
            raise RuntimeError("ItmHardNegDataset: call new_epoch(rng) first")
        ids = self.txt_db.combine_inputs(self.train_raw_ids[i])
        feat, bb7, _ = self._img_feat(self.train_imgs[i])
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "target": int(self.labels[i])}


class ConcatDataset:
    """Same-task datasets end to end, with their lengths merged (the
    reference's ``ConcatDataset``): index i goes to the dataset whose
    range holds it."""

    def __init__(self, datasets: Sequence[VLDataset]):
        self.datasets = list(datasets)
        self._offsets = list(np.cumsum([0] + [len(d) for d in
                                              self.datasets[:-1]]))
        self._total = sum(len(d) for d in self.datasets)
        self._merge_lens()
        self.pad_token_id = self.datasets[0].pad_token_id
        self.slot_target_keys = self.datasets[0].slot_target_keys

    def _merge_lens(self):
        self.lens = [n for d in self.datasets for n in d.lens]
        self.txt_lens = [n for d in self.datasets for n in d.txt_lens]

    def __len__(self):
        return self._total

    def _route(self, i):
        for k in range(len(self.datasets) - 1, -1, -1):
            if i >= self._offsets[k]:
                return self.datasets[k], i - self._offsets[k]
        raise IndexError(i)

    def get_example(self, i, rng):
        ds, j = self._route(i)
        return ds.get_example(j, rng)

    def prefetch(self, indices: Sequence[int]):
        """Each dataset's ``prefetch`` of its share of ``indices``."""
        parts: Dict[int, List[int]] = {}
        for i in indices:
            ds, j = self._route(i)
            parts.setdefault(id(ds), []).append(j)
        for ds in self.datasets:
            if id(ds) in parts:
                ds.prefetch(parts[id(ds)])

    def new_epoch(self, rng):
        for d in self.datasets:
            if hasattr(d, "new_epoch"):
                d.new_epoch(rng)
        # a dataset's epoch may change its lengths (itm's swapped captions)
        self._merge_lens()

    def collate(self, examples, spec):
        return self.datasets[0].collate(examples, spec)


class ItmRankDataset(VLDataset):
    """Retrieval finetuning groups: for each text, its image (target 1),
    ``neg_sample_size`` other images with the text and
    ``neg_sample_size`` other texts with the image (target 0), as one
    list of examples that the loader flattens; ``sample_size`` rows a
    group."""

    def __init__(self, txt_db, img_db, neg_sample_size: int = 1):
        super().__init__(txt_db, img_db)
        if neg_sample_size <= 0:
            raise ValueError("neg_sample_size must be positive")
        self.neg_sample_size = neg_sample_size
        self.img2txts = txt_db.img2txts
        self.all_imgs = sorted(self.img2txts.keys())
        self.all_txts = list(self.ids)

    @property
    def sample_size(self) -> int:
        return 1 + 2 * self.neg_sample_size

    def _row(self, ids, img, target):
        """One pair: text ids with an image name or its (feat, bb7)."""
        feat, bb7 = self.img_db[img] if isinstance(img, str) else img
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "target": target}

    def _text(self, txt_id):
        return self.txt_db.combine_inputs(self.txt_db[txt_id]["input_ids"])

    def _anchor(self, i):
        """(text id, its image name, the image's (feat, bb7), the image's
        texts, the text's ids)."""
        id_ = self.ids[i]
        gt_img = self.txt2img[id_]
        ids = self.txt_db.combine_inputs(self.example_record(i)["input_ids"])
        return id_, gt_img, self.img_db[gt_img], self.img2txts[gt_img], ids

    def get_example(self, i, rng):
        _, gt_img, gt, gt_txts, ids = self._anchor(i)
        group = [self._row(ids, gt, 1)]
        for _ in range(self.neg_sample_size):
            group.append(self._row(
                ids, sample_negative(rng, self.all_imgs, [gt_img]), 0))
        for _ in range(self.neg_sample_size):
            group.append(self._row(
                self._text(sample_negative(rng, self.all_txts, gt_txts)),
                gt, 0))
        return group


class ItmRankHardNegDataset(ItmRankDataset):
    """Rank groups with mined hard negatives: [positive, ``hard_neg_size``
    hard images, ``hard_neg_size`` hard texts, ``neg_sample_size`` random
    images, ``neg_sample_size`` random texts] (hard negatives are added
    to the random ones). Each hard slot draws from the text's pool of
    images (``txt2hardimgs``) or the image's pool of texts
    (``img2hardtxts``); until a mining pass fills them
    (``reload_hard_negs``), it falls back to a random negative, so the
    group size never changes."""

    def __init__(self, txt_db, img_db, neg_sample_size: int = 1,
                 hard_neg_size: int = 1,
                 hard_negs: Optional[Dict[str, Dict[str, List[str]]]] = None):
        super().__init__(txt_db, img_db, neg_sample_size)
        self.hard_neg_size = hard_neg_size
        self.txt2hardimgs: Dict[str, List[str]] = {}
        self.img2hardtxts: Dict[str, List[str]] = {}
        if hard_negs:
            self.reload_hard_negs(hard_negs)

    @property
    def sample_size(self) -> int:
        return 1 + 2 * (self.neg_sample_size + self.hard_neg_size)

    def reload_hard_negs(self, path_or_dict):
        """New pools: a mining pass's {"txt2hardimgs", "img2hardtxts"} (or
        the JSON file holding it), or the legacy flat {text: images}."""
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                path_or_dict = json.load(f)
        d = dict(path_or_dict)
        if "txt2hardimgs" in d or "img2hardtxts" in d:
            self.txt2hardimgs = dict(d.get("txt2hardimgs", {}))
            self.img2hardtxts = dict(d.get("img2hardtxts", {}))
        else:
            self.txt2hardimgs = d
            self.img2hardtxts = {}

    def get_example(self, i, rng):
        id_, gt_img, gt, gt_txts, ids = self._anchor(i)
        group = [self._row(ids, gt, 1)]
        img_pool = self.txt2hardimgs.get(id_) or []
        txt_pool = self.img2hardtxts.get(gt_img) or []
        for _ in range(self.hard_neg_size):
            neg = (img_pool[int(rng.integers(0, len(img_pool)))] if img_pool
                   else sample_negative(rng, self.all_imgs, [gt_img]))
            group.append(self._row(ids, neg, 0))
        for _ in range(self.hard_neg_size):
            neg = (txt_pool[int(rng.integers(0, len(txt_pool)))] if txt_pool
                   else sample_negative(rng, self.all_txts, gt_txts))
            group.append(self._row(self._text(neg), gt, 0))
        for _ in range(self.neg_sample_size):
            group.append(self._row(
                ids, sample_negative(rng, self.all_imgs, [gt_img]), 0))
        for _ in range(self.neg_sample_size):
            group.append(self._row(
                self._text(sample_negative(rng, self.all_txts, gt_txts)),
                gt, 0))
        return group


class ItmEvalDataset(VLDataset):
    """The full retrieval evaluation's texts (all of the database's, or
    ``ids``) and their images sorted by (region count, name), the order
    the evaluation scores them in (the reference breaks ties of region
    count in set order, which varies with the hash seed)."""

    def __init__(self, txt_db, img_db, ids: Optional[Sequence[str]] = None):
        super().__init__(txt_db, img_db, ids)
        self.all_img_ids = sorted({self.txt2img[i] for i in self.ids},
                                  key=lambda x: (img_db.name2nbb[x], x))

    def text_example(self, i):
        return self.txt_db.combine_inputs(self.example_record(i)["input_ids"])


# ------------------------------------------------------- VQA, VE, NLVR2
class VqaDataset(VLDataset):
    """VQA with soft-score targets: ``soft_target`` [num_answers] holds
    each of the record's ``target`` labels at its score."""

    def __init__(self, txt_db, img_db, num_answers: int):
        super().__init__(txt_db, img_db)
        self.num_answers = num_answers

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        feat, bb7, _ = self._img_feat(rec["img_fname"])
        target = np.zeros(self.num_answers, np.float32)
        labels = rec.get("target", {})
        for lbl, score in zip(labels.get("labels", []),
                              labels.get("scores", [])):
            target[int(lbl)] = float(score)
        return {"input_ids": ids, "img_feat": feat, "img_pos_feat": bb7,
                "soft_target": target}


class VeDataset(VqaDataset):
    """Visual entailment: VQA over three answers."""

    def __init__(self, txt_db, img_db):
        super().__init__(txt_db, img_db, num_answers=3)


class Nlvr2TwoRowDataset(VLDataset):
    """NLVR2's paired formats: each example is two rows, the statement with
    the left image and with the right one (the record's ``img_fnames``,
    else its ``img_fname`` twice), kept adjacent by the loader; with
    ``use_img_type`` the rows' regions have type 1 and 2."""

    def __init__(self, txt_db, img_db, use_img_type: bool = True):
        super().__init__(txt_db, img_db)
        self.use_img_type = use_img_type

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        fnames = rec.get("img_fnames", [rec.get("img_fname")] * 2)
        rows = []
        for k, fn in enumerate(fnames[:2]):
            f, b, n = self._img_feat(fn)
            row = {"input_ids": ids, "img_feat": f, "img_pos_feat": b,
                   "target": int(rec.get("target", 0))}
            if self.use_img_type:
                row["img_type_ids"] = np.full(n, k + 1, np.int32)
            rows.append(row)
        return rows

    @property
    def sample_size(self):
        return 2

    def collate(self, examples, spec):
        """``collate_batch`` plus ``img_type_ids`` [B, Nb] (padded regions
        type 1) and one target a pair of rows."""
        batch = collate_batch(examples, spec, self.pad_token_id)
        if self.use_img_type:
            B, Nb = spec.batch_size, spec.num_bb
            t = np.ones((B, Nb), np.int32)
            for b, e in enumerate(examples):
                ti = np.asarray(e.get("img_type_ids", []))[:Nb]
                t[b, :ti.shape[0]] = ti
            batch["img_type_ids"] = t
        batch["targets"] = batch["targets"][::2]
        return batch


class Nlvr2PairedDataset(VLDataset):
    """NLVR2's triplet format: one row an example, the statement with both
    images' regions one after the other (type ids 1 and 2); ``lens``
    counts the first image's regions twice."""

    def __init__(self, txt_db, img_db, use_img_type: bool = True):
        super().__init__(txt_db, img_db)
        self.use_img_type = use_img_type
        self.lens = [tl + 2 * self.img_db.name2nbb[self.txt2img[i]]
                     for tl, i in zip(self.txt_lens, self.ids)]

    def get_example(self, i, rng):
        rec = self.example_record(i)
        ids = self.txt_db.combine_inputs(rec["input_ids"])
        fnames = rec.get("img_fnames", [rec.get("img_fname")] * 2)
        feats, bbs, types = [], [], []
        for k, fn in enumerate(fnames[:2]):
            f, b, n = self._img_feat(fn)
            feats.append(f)
            bbs.append(b)
            types.append(np.full(n, k + 1, np.int32))
        ex = {"input_ids": ids,
              "img_feat": np.concatenate(feats, 0),
              "img_pos_feat": np.concatenate(bbs, 0),
              "target": int(rec.get("target", 0))}
        if self.use_img_type:
            ex["img_type_ids"] = np.concatenate(types, 0)
        return ex

    def collate(self, examples, spec):
        """``collate_batch`` plus ``img_type_ids`` [B, Nb] (padded regions
        type 1; they are masked out of attention)."""
        batch = collate_batch(examples, spec, self.pad_token_id)
        if self.use_img_type:
            B, Nb = spec.batch_size, spec.num_bb
            t = np.zeros((B, Nb), np.int32)
            for b, e in enumerate(examples):
                ti = np.asarray(e["img_type_ids"])[:Nb]
                t[b, :ti.shape[0]] = ti
            t[t == 0] = 1
            batch["img_type_ids"] = t
        return batch


def batches(ds: VLDataset, spec: BucketSpec, indices: Sequence[int],
            rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
    """Collated batches of ``spec.batch_size`` examples over ``indices``
    in order (a trailing partial batch is padded)."""
    B = spec.batch_size
    return [ds.collate([ds.get_example(i, rng) for i in indices[s:s + B]],
                       spec) for s in range(0, len(indices), B)]
