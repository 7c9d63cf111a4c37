"""Masking for the pretraining objectives (copies of uc2_tpu/data/masking.py
``mask_tokens``, ``comask_tokens``, ``mix_comask``, ``region_mask`` and
``region_mask_with_token_labels``, with the same ``np.random.Generator``
draws in the same order, so the same generator state gives the same masks
in both packages):

* BERT 80/10/10 token masking with at least one masked token;
* cross-lingual co-masking over ``[CLS] lang1 [SEP] lang2 [SEP]`` pairs:
  a masked lang1 token also masks its aligned lang2 word ('full': every
  subtoken of both words; 'random': one aligned lang2 subtoken), and
  'mix', half random co-masking and half plain masking;
* region masking with at least one masked region, and its hard targets:
  a random subtoken of each masked region's top detector class.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from uc2_torch.data.labels import LabelVocab

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


def _word_of(pos: int, word2ids: Sequence[Sequence[int]]) -> int:
    for w_idx, toks in enumerate(word2ids):
        if pos in toks:
            return w_idx
    return 0


def comask_tokens(example: Dict, v_range, mask_id: int,
                  rng: np.random.Generator, mode: str = "full",
                  prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Co-masking of a translation pair. ``example`` holds input_ids (the
    raw pair, lang1 [SEP, SEP] lang2), input_ids_lang1, word2ids_lang1,
    word2ids_lang2 and lang1_lang2_walign (lang1 word -> [lang2 words]).
    Lang1 token i sits at position i, lang2 token j at j + len1 + 2.
    Returns (new_ids, labels), labels -1 where nothing is predicted."""
    tokens = np.asarray(example["input_ids"]).copy()
    L = tokens.shape[0]
    labels = np.full(L, IGNORE, np.int64)
    len1 = len(example["input_ids_lang1"])
    w2i_1 = example["word2ids_lang1"]
    w2i_2 = example["word2ids_lang2"]
    walign = {int(k): v for k, v in example["lang1_lang2_walign"].items()}

    def aligned(i_lang1: int):
        w1 = _word_of(i_lang1, w2i_1)
        ids1 = list(w2i_1[w1]) if mode == "full" else None
        w2 = walign.get(w1)
        if mode == "full":
            ids2 = list(w2i_2[w2[0]]) if w2 is not None else list(w2i_2[0])
            return ids1, ids2
        if w2 is None:
            return None, [0]
        toks2 = w2i_2[w2[0]]
        return None, [toks2[int(rng.integers(0, len(toks2)))]]

    any_masked = False
    for i in range(min(len1, L)):
        u = rng.random()
        if u < prob:
            ids1, ids2 = aligned(i)
            pos1 = ids1 if ids1 is not None else [i]
            pos2 = [j + len1 + 2 for j in ids2]
            orig = {p: tokens[p] for p in pos1 + pos2 if p < L}
            sub = u / prob
            if sub < 0.8:
                for p in orig:
                    tokens[p] = mask_id
            elif sub < 0.9:
                for p in orig:
                    tokens[p] = int(rng.integers(v_range[0], v_range[1]))
            for p, t in orig.items():
                labels[p] = t
            any_masked = True

    if not any_masked:
        ids1, ids2 = aligned(0)
        pos1 = ids1 if ids1 is not None else [0]
        pos2 = [j + len1 + 2 for j in ids2]
        for p in pos1 + pos2:
            if p < L:
                labels[p] = tokens[p]
                tokens[p] = mask_id
    return tokens, labels


def mix_comask(example, v_range, mask_id, rng, prob=0.15):
    """'mix': random co-masking or plain masking of the pair, 50/50."""
    if rng.random() < 0.5:
        return comask_tokens(example, v_range, mask_id, rng, "random", prob)
    return mask_tokens(np.asarray(example["input_ids"]), v_range, mask_id,
                       rng, prob)


def region_mask(rng: np.random.Generator, num_bb: int,
                prob: float = 0.15) -> np.ndarray:
    """Bool [num_bb], each region masked with probability ``prob``, at
    least one."""
    m = rng.random(num_bb) < prob
    if not m.any():
        m[int(rng.integers(0, num_bb))] = True
    return m


def region_mask_with_token_labels(
        rng: np.random.Generator, num_bb: int, soft_labels: np.ndarray,
        vocab: LabelVocab, lang: str = "en", prob: float = 0.15
) -> Tuple[np.ndarray, np.ndarray]:
    """(mask [num_bb] bool, labels [num_bb]): each masked region's label
    is a uniformly drawn subtoken of its top detector class in ``lang``;
    -1 elsewhere. At least one region is masked."""
    mask = np.zeros(num_bb, bool)
    labels = np.full(num_bb, IGNORE, np.int64)

    def sample_label(i):
        top1 = int(np.argmax(soft_labels[i]))
        cand = vocab.class_token_ids(top1, lang)
        return int(cand[int(rng.integers(0, len(cand)))])

    for i in range(num_bb):
        if rng.random() < prob:
            mask[i] = True
            labels[i] = sample_label(i)
    if not mask.any():
        i = int(rng.integers(0, num_bb))
        mask[i] = True
        labels[i] = sample_label(i)
    return mask, labels
