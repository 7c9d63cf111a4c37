"""Static-shape batch assembly for the mlm family (a copy of the mlm part
of uc2_tpu/data/collate.py ``collate_batch``).

Every batch is padded to one bucket shape (Lt text tokens, Nb regions,
B rows) and its prediction slots are fixed-size arrays:

  masked_pos    [B, M] int32 - joint-sequence indices ([txt | img] layout)
  masked_weight [B, M] float32 - 1 for live slots
  txt_labels    [B, M] int32 - the token to predict at each slot

Region features are copied with numpy (the reference's threaded native
packer gives the same arrays).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One static batch shape."""
    txt_len: int          # Lt: text length incl. CLS/SEP
    num_bb: int           # Nb: max regions
    batch_size: int
    max_masked: int = 0   # M: prediction slots


def collate_batch(examples: List[Dict[str, Any]], spec: BucketSpec,
                  pad_token_id: int = 1) -> Dict[str, np.ndarray]:
    """Assemble a static-shape mlm batch from examples with ``input_ids``
    [L], optional ``position_ids`` [L], ``img_feat`` [nbb, D],
    ``img_pos_feat`` [nbb, 7] and ``txt_labels`` [L] (-1 = not a slot).

    Returns input_ids, attn_mask (text then regions), ex_mask (1 for real
    rows), img_feat and img_pos_feat when any example has an image,
    position_ids when any has them, and with ``spec.max_masked`` the slot
    arrays (text slots in order, truncated at M)."""
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
    if M:
        out["masked_pos"] = np.zeros((B, M), np.int32)
        out["masked_weight"] = np.zeros((B, M), np.float32)
        out["txt_labels"] = np.zeros((B, M), np.int32)

    for b, e in enumerate(examples):
        ids = np.asarray(e["input_ids"])[:Lt]
        L = ids.shape[0]
        out["input_ids"][b, :L] = ids
        out["attn_mask"][b, :L] = 1
        out["ex_mask"][b] = 1.0
        if "position_ids" in e:
            out["position_ids"][b, :L] = np.asarray(e["position_ids"])[:Lt]
        if "img_feat" in e:
            feat = np.asarray(e["img_feat"])[:Nb]
            nbb = feat.shape[0]
            out["img_feat"][b, :nbb] = feat
            out["img_pos_feat"][b, :nbb] = np.asarray(e["img_pos_feat"])[:Nb]
            out["attn_mask"][b, Lt:Lt + nbb] = 1
        if M and "txt_labels" in e:
            tl = np.asarray(e["txt_labels"])[:Lt]
            pos = np.flatnonzero(tl != -1)[:M]
            k = len(pos)
            out["masked_pos"][b, :k] = pos
            out["masked_weight"][b, :k] = 1.0
            # label padding stays 0; weight 0 kills the padded slots' loss
            out["txt_labels"][b, :k] = tl[pos]
    return out
