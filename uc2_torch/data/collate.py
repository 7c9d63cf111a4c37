"""Static-shape batch assembly (a copy of uc2_tpu/data/collate.py
``collate_batch``, ``BucketSpec``, ``default_buckets`` and
``pick_bucket``).

Every batch is padded to one bucket shape (Lt text tokens, Nb regions,
B rows) and its prediction slots are fixed-size arrays:

  masked_pos    [B, M] int32 - joint-sequence indices ([txt | img] layout)
  masked_weight [B, M] float32 - 1 for live slots
  txt_labels    [B, M] int32 - the token to predict at each slot
  plus the per-slot targets a task names (``slot_target_keys``).

Region features are copied with numpy (the reference's threaded native
packer gives the same arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One static batch shape."""
    txt_len: int          # Lt: text length incl. CLS/SEP
    num_bb: int           # Nb: max regions
    batch_size: int
    max_masked: int = 0   # M: prediction slots

    @property
    def joint_len(self):
        return self.txt_len + self.num_bb


def default_buckets(max_txt_len: int = 60, max_bb: int = 100,
                    tokens_per_batch: int = 10240,
                    mask_frac: float = 0.5) -> List[BucketSpec]:
    """Three buckets with about ``tokens_per_batch`` joint tokens per batch
    (the original token-count batching at fixed shapes); batch sizes are
    multiples of 8."""
    shapes = [(max_txt_len // 3 + 2, min(36, max_bb)),
              (max_txt_len * 2 // 3 + 2, min(64, max_bb)),
              (max_txt_len + 2, max_bb)]
    out = []
    for lt, nb in shapes:
        b = max(8, int(tokens_per_batch / (lt + nb)) // 8 * 8)
        m = max(8, int((lt + nb) * mask_frac) // 8 * 8)
        out.append(BucketSpec(lt, nb, b, m))
    return out


def pick_bucket(buckets: Sequence[BucketSpec], txt_len: int,
                num_bb: int) -> Optional[int]:
    """Index of the smallest bucket that fits (buckets sorted ascending),
    or None."""
    for i, s in enumerate(buckets):
        if txt_len <= s.txt_len and num_bb <= s.num_bb:
            return i
    return None


def collate_batch(examples: List[Dict[str, Any]], spec: BucketSpec,
                  pad_token_id: int = 1,
                  slot_target_keys: Sequence[str] = ()
                  ) -> Dict[str, np.ndarray]:
    """Assemble a static-shape batch from examples with ``input_ids`` [L]
    and, optionally, ``position_ids`` [L], ``img_feat`` [nbb, D],
    ``img_pos_feat`` [nbb, 7], ``img_masks`` [nbb] bool (masked regions),
    ``txt_labels`` [L] (-1 = not a slot), ``img_txt_labels`` [nbb] (the
    token to predict at a masked region), ``img_mask_tgt`` [nbb] bool (the
    regions that get slots, else ``img_masks``), per-region targets
    (``feat_targets`` [nbb, D], ``label_targets`` [nbb, C]), per-token
    targets (``txt_*`` [L, C]), ``target`` (itm, nlvr2) and
    ``soft_target`` [C] (vqa, ve).

    Returns input_ids, attn_mask (text then regions), ex_mask (1 for real
    rows), img_feat and img_pos_feat when any example has an image (masked
    regions' features zeroed), img_masks, targets, soft_targets [B, C] fp32
    and position_ids when any example has them, and with
    ``spec.max_masked`` the slot arrays: text slots first, then region
    slots at joint index Lt + i, truncated at M (a region slot's label is 0
    when the example has no ``img_txt_labels``). Each of
    ``slot_target_keys`` some example has is gathered to [B, M, C] at the
    slots (``txt_*`` keys at the text slots, the others at the region
    slots after them), fp16 staying fp16, else fp32."""
    B = spec.batch_size
    Lt, Nb, M = spec.txt_len, spec.num_bb, spec.max_masked
    if len(examples) > B:
        raise ValueError(f"{len(examples)} examples for a batch of {B}")
    has_img = any("img_feat" in e for e in examples)
    out: Dict[str, np.ndarray] = {
        "input_ids": np.full((B, Lt), pad_token_id, np.int32),
        "attn_mask": np.zeros((B, Lt + Nb if has_img else Lt), np.int32),
        "ex_mask": np.zeros((B,), np.float32),
    }
    if has_img:
        feat0 = np.asarray(next(e for e in examples
                                if "img_feat" in e)["img_feat"])
        # the feature slab keeps the examples' dtype (fp16 stays fp16)
        out["img_feat"] = np.zeros((B, Nb, feat0.shape[-1]), feat0.dtype)
        out["img_pos_feat"] = np.zeros((B, Nb, 7), np.float32)
    if any("position_ids" in e for e in examples):
        out["position_ids"] = np.full((B, Lt), pad_token_id, np.int32)
    if any("img_masks" in e for e in examples):
        out["img_masks"] = np.zeros((B, Nb), bool)
    if any("target" in e for e in examples):
        out["targets"] = np.zeros((B,), np.int32)
    if any("soft_target" in e for e in examples):
        C = np.asarray(examples[0]["soft_target"]).shape[-1]
        out["soft_targets"] = np.zeros((B, C), np.float32)
    if M:
        out["masked_pos"] = np.zeros((B, M), np.int32)
        out["masked_weight"] = np.zeros((B, M), np.float32)
        out["txt_labels"] = np.zeros((B, M), np.int32)
        for key in slot_target_keys:
            ex0 = next((e for e in examples if key in e), None)
            if ex0 is not None:
                tgt0 = np.asarray(ex0[key])
                out[key] = np.zeros((B, M, tgt0.shape[-1]),
                                    tgt0.dtype if tgt0.dtype == np.float16
                                    else np.float32)

    for b, e in enumerate(examples):
        ids = np.asarray(e["input_ids"])[:Lt]
        L = ids.shape[0]
        out["input_ids"][b, :L] = ids
        out["attn_mask"][b, :L] = 1
        out["ex_mask"][b] = 1.0
        if "position_ids" in e:
            out["position_ids"][b, :L] = np.asarray(e["position_ids"])[:Lt]
        nbb = 0
        if "img_feat" in e:
            feat = np.asarray(e["img_feat"])[:Nb]
            nbb = feat.shape[0]
            out["img_feat"][b, :nbb] = feat
            out["img_pos_feat"][b, :nbb] = np.asarray(e["img_pos_feat"])[:Nb]
            out["attn_mask"][b, Lt:Lt + nbb] = 1
        if "img_masks" in e:
            masks = np.asarray(e["img_masks"])
            out["img_masks"][b, :nbb] = masks[:Nb]
            # masked regions' input features are zeroed; the model adds
            # the mask embedding on top
            out["img_feat"][b, :nbb][masks[:nbb]] = 0.0
        if "target" in e:
            out["targets"][b] = e["target"]
        if "soft_target" in e:
            out["soft_targets"][b] = np.asarray(e["soft_target"])
        if not M:
            continue
        txt_pos: List[int] = []
        txt_lab: List[int] = []
        if "txt_labels" in e:
            tl = np.asarray(e["txt_labels"])[:Lt]
            p = np.flatnonzero(tl != -1)
            txt_pos, txt_lab = p.tolist(), tl[p].tolist()
        region_idx: List[int] = []
        reg_lab: List[int] = []
        tgt_key = ("img_mask_tgt" if "img_mask_tgt" in e
                   else "img_masks" if "img_masks" in e else None)
        if tgt_key is not None and any(
                k in e for k in ("img_txt_labels", "feat_targets",
                                 "label_targets")):
            region_idx = np.flatnonzero(np.asarray(e[tgt_key])[:Nb]).tolist()
            reg_lab = (np.asarray(e["img_txt_labels"])[region_idx].tolist()
                       if "img_txt_labels" in e else [0] * len(region_idx))
        # text slots first, then regions, truncated at M
        n_txt = min(len(txt_pos), M)
        n_reg = min(len(region_idx), M - n_txt)
        k = n_txt + n_reg
        out["masked_pos"][b, :k] = txt_pos[:n_txt] + [
            Lt + i for i in region_idx[:n_reg]]
        out["masked_weight"][b, :k] = 1.0
        # label padding stays 0; weight 0 kills the padded slots' loss
        out["txt_labels"][b, :k] = txt_lab[:n_txt] + reg_lab[:n_reg]
        for key in slot_target_keys:
            if key not in out or key not in e:
                continue
            tgt = np.asarray(e[key])
            if key.startswith("txt_"):
                out[key][b, :n_txt] = tgt[txt_pos[:n_txt]]
            else:
                take = region_idx[:n_reg]
                out[key][b, n_txt:n_txt + len(take)] = tgt[take]
    return out
