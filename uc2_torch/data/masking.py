"""BERT 80/10/10 token masking (a copy of uc2_tpu/data/masking.py
``mask_tokens``, same ``np.random.Generator`` draws, so the same generator
state gives the same masks in both packages)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IGNORE = -1


def mask_tokens(ids: np.ndarray, v_range: Tuple[int, int], mask_id: int,
                rng: np.random.Generator, prob: float = 0.15,
                maskable: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """ids: int array [L]. Returns (new_ids, labels) with labels the
    original token at masked slots and -1 elsewhere. Each position is
    selected with probability ``prob`` (at least one is); a selected token
    becomes ``mask_id`` (80%), a random id in ``v_range`` (10%) or stays
    (10%). ``maskable`` restricts the candidate positions."""
    ids = np.asarray(ids)
    L = ids.shape[0]
    u = rng.random(L)
    if maskable is None:
        maskable = np.ones(L, bool)
    sel = (u < prob) & maskable
    if not sel.any():
        # at least one masked slot: the first maskable position
        first = int(np.flatnonzero(maskable)[0]) if maskable.any() else 0
        labels = np.full(L, IGNORE, ids.dtype)
        labels[first] = ids[first]
        out = ids.copy()
        out[first] = mask_id
        return out, labels
    labels = np.where(sel, ids, IGNORE)
    # the sub-probability decides the replacement (u/prob < .8 -> mask,
    # < .9 -> random token)
    sub = u / prob
    out = ids.copy()
    rand_tok = rng.integers(v_range[0], v_range[1], L)
    out[sel & (sub < 0.8)] = mask_id
    repl = sel & (sub >= 0.8) & (sub < 0.9)
    out[repl] = rand_tok[repl]
    return out, labels.astype(np.int64)


def mlm_example(ids, feat, bb7, rng: np.random.Generator, vocab: int,
                cls_: int = 0, sep: int = 2, prob: float = 0.15):
    """One mlm example as uc2_tpu/data/datasets.py ``MlmDataset`` builds
    it: the caption's tokens are masked (mask id vocab - 1, random tokens
    from [4, vocab - 1)), then wrapped in CLS ... SEP, which are never
    prediction slots."""
    raw, raw_labels = mask_tokens(np.asarray(ids), (4, vocab - 1), vocab - 1,
                                  rng, prob)
    return {"input_ids": np.concatenate([[cls_], raw, [sep]]).astype(np.int64),
            "txt_labels": np.concatenate([[IGNORE], raw_labels,
                                          [IGNORE]]).astype(np.int64),
            "img_feat": feat, "img_pos_feat": bb7}
