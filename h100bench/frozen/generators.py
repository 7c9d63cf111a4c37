"""Seeded inputs of the cells: weights, the retrieval gallery, NLVR2
batches and the pretraining mix's steps.

The gallery is ``synth_gallery`` of ``uc2_torch/data/memdb.py`` at commit
9035995, rewritten so that its features are drawn on the card in one call
and its region counts and caption lengths are the same for every seed:
region counts even over [min_bb, max_bb]; fp16 standard-normal features;
boxes [x1, y1, x2, y2, w, h] with corners in [0, 0.5) and sides in
[1e-3, 0.5 + 1e-3), plus w * h; captions of 2 n subtokens, n in
[min_words, max_words] (even in the gallery, uniform elsewhere), between
CLS and SEP. NLVR2 rows are drawn the same
way, one statement and two images a row, in the triplet layout of
``Nlvr2PairedDataset``'s collate at that commit: [text padded to Lt |
image 1's regions, image 2's regions, padding to Nb], region type ids 1
and 2 (1 on padding).

Every stream is keyed by ``sub_seed(seed, ...)``, so one seed gives the
same inputs whatever else a run does.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream ``keys`` of the run ``seed`` (any
    non-negative whole number)."""
    words = [int(seed)] + [zlib.crc32(str(k).encode()) for k in keys]
    a, b = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(a) << 31) ^ int(b)


def make_weights(shapes: Dict[str, tuple], seed: int, device,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    """fp32 weights from one draw on ``device``: normal(0, std) for every
    tensor, plus 1 on LayerNorm scales. Returns views of one buffer."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "w"))
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std)
    out, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[off:off + n].view(shape)
        if name.endswith(".weight") and ("LayerNorm" in name
                                         or "layer_norm" in name):
            t.add_(1.0)
        out[name] = t
        off += n
    return out


def _boxes(rng, shape):
    """bb7 boxes of ``shape`` [..., 7]."""
    x1y1 = rng.random(shape + (2,), np.float32) * 0.5
    wh = rng.random(shape + (2,), np.float32) * 0.5 + 1e-3
    bb = np.concatenate([x1y1, x1y1 + wh, wh], axis=-1)
    return np.concatenate([bb, bb[..., 4:5] * bb[..., 5:6]], axis=-1)


def _captions(rng, n, t, words=None):
    """``n`` token lists of 2 x ``words`` subtokens (each drawn uniform in
    [min_words, max_words] where not given)."""
    if words is None:
        words = rng.integers(t["min_words"], t["max_words"] + 1, n)
    lo, hi = t["first_word_id"], t["vocab_size"] - 1
    return [rng.integers(lo, hi, 2 * w).tolist() for w in words]


def _even(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers that take each value of [lo, hi] equally often
    (to one), in order."""
    return lo + (np.arange(n) * (hi - lo + 1)) // n


def gallery(seed: int, t: Dict, keep_bb: int, device):
    """The retrieval gallery of traffic ``t``: ``n_imgs`` images and
    ``txt_per_img`` captions each. Every seed draws the same region counts
    and caption lengths (each value of their ranges equally often), given
    to the images and captions in an order drawn from the seed, so every
    seed scores the same batches. Returns (feats [n_imgs, keep_bb, img_dim]
    fp16 on the host, bb7 [n_imgs, keep_bb, 7], nbb [n_imgs], captions
    [n_imgs * txt_per_img] token lists (without CLS/SEP), caption -> image
    index). Only the first ``keep_bb`` regions of an image are drawn: a
    scored image is cut to ``num_bb`` regions."""
    rng = np.random.default_rng(sub_seed(seed, "gallery"))
    n, n_txt = t["n_imgs"], t["n_imgs"] * t["txt_per_img"]
    nbb = rng.permutation(_even(t["min_bb"], t["max_bb"], n))
    bb7 = _boxes(rng, (n, keep_bb))
    caps = _captions(rng, n_txt, t, rng.permutation(
        _even(t["min_words"], t["max_words"], n_txt)))
    cap2img = np.repeat(np.arange(n), t["txt_per_img"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "feat"))
    feats = torch.randn((n, keep_bb, t["img_dim"]), generator=gen,
                        device=device).half().cpu().numpy()
    return feats, bb7, nbb, caps, cap2img


def nlvr2_batch(seed: int, step: int, t: Dict, device):
    """Batch ``step`` of the NLVR2 triplet traffic ``t``: (the batch as
    device tensors in the dtypes the port's collate and device copy give,
    (text tokens, regions) of each row on the host)."""
    rng = np.random.default_rng(sub_seed(seed, "nlvr2", step))
    B, Lt, mb = t["batch_size"], t["txt_len"], t["max_bb"]
    Nb = 2 * mb
    nr = rng.integers(t["min_bb"], mb + 1, (B, 2))
    caps = _captions(rng, B, t)
    ids = np.full((B, Lt), t["pad_token_id"], np.int32)
    mask = np.zeros((B, Lt + Nb), np.int32)
    types = np.ones((B, Nb), np.int32)
    for b, c in enumerate(caps):
        row = [t["cls_token_id"]] + c + [t["sep_token_id"]]
        ids[b, :len(row)] = row
        mask[b, :len(row)] = 1
        mask[b, Lt:Lt + nr[b].sum()] = 1
        types[b, nr[b, 0]:nr[b].sum()] = 2
    regions = mask[:, Lt:].astype(bool)
    bb7 = _boxes(rng, (B, Nb)) * regions[..., None]
    targets = rng.integers(0, 2, B).astype(np.int32)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "nlvr2-feat", step))
    feat = torch.randn((B, Nb, t["img_dim"]), generator=gen, device=device)
    host = {"input_ids": ids, "attn_mask": mask, "img_pos_feat": bb7,
            "img_type_ids": types, "targets": targets,
            "_regions": regions}
    dev = {k: _to(v, device) for k, v in host.items()}
    dev["img_feat"] = feat.half().float() * dev.pop("_regions")[..., None]
    return dev, (np.asarray([len(c) + 2 for c in caps]), nr.sum(1))


def _to(a, device):
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def pick_bucket(buckets, txt_len: int, num_bb: int):
    """Index of the smallest bucket [Lt, Nb, ...] that fits a row's text
    tokens and regions, or None: ``pick_bucket`` of
    ``uc2_torch/data/collate.py`` at 9035995, the rule by which the port's
    ``BucketBatcher`` routes every row."""
    for i, (lt, nb, *_) in enumerate(buckets):
        if txt_len <= lt and num_bb <= nb:
            return i
    return None


_ROWS: Dict[tuple, list] = {}


def bucket_rows(t: Dict, task: str):
    """Every row the mix ``t`` draws for ``task``, each as likely as the
    next, as [words of the first text, words of the second (tlm; else 0),
    regions], split by the bucket ``pick_bucket`` routes it to: one array
    [n, 3] a bucket. Words are even over [min_words, max_words], regions
    over [min_bb, max_bb]."""
    key = (task, str(t["buckets"]), t["min_words"], t["max_words"],
           t["min_bb"], t["max_bb"])
    if key not in _ROWS:
        _ROWS[key] = _route(t, task)
    return _ROWS[key]


def _route(t, task):
    w = np.arange(t["min_words"], t["max_words"] + 1)
    w2 = w if task == "tlm" else np.zeros(1, int)
    nb = np.arange(t["min_bb"], t["max_bb"] + 1)
    rows = np.stack(np.meshgrid(w, w2, nb, indexing="ij"), -1).reshape(-1, 3)
    route = [pick_bucket(t["buckets"], int(_text_tokens(task, a, b)), int(n))
             for a, b, n in rows]
    if None in route:
        raise ValueError(f"{task}: a row fits no bucket of {t['buckets']}")
    route = np.asarray(route)
    return [rows[route == bi] for bi in range(len(t["buckets"]))]


def _text_tokens(task, w1, w2):
    """Text tokens of a row of ``w1`` (and, in tlm, ``w2``) words of two
    subtokens: [CLS] words [SEP], or [CLS] lang1 [SEP] [SEP] lang2 [SEP]."""
    return 2 * w1 + 2 + (2 * w2 + 2 if task == "tlm" else 0)


def bucket_deck(t: Dict, task: str):
    """Whole weights, ``bucket_deck`` cards in all, of the buckets of
    ``task``'s steps: each bucket's rows over its batch size, as the port's
    ``BucketBatcher`` makes n_b / B_b batches of the n_b rows it routes to
    bucket b; rounded by the largest remainder."""
    share = np.asarray([len(r) / b[2] for r, b in
                        zip(bucket_rows(t, task), t["buckets"])])
    exact = share / share.sum() * t["bucket_deck"]
    deck = np.floor(exact).astype(int)
    rest = np.argsort(-(exact - deck), kind="stable")
    deck[rest[:t["bucket_deck"] - deck.sum()]] += 1
    return [int(x) for x in deck]


def task_and_bucket(seed: int, i: int, t: Dict):
    """(task, bucket index) of the mix's step ``i`` after the check's steps.
    Tasks come from a deck holding each task of ``t["mix"]`` its weight
    times; each task's buckets from a deck of its own (``bucket_deck``),
    dealt at that task's own count of steps. Each deck is dealt in a fresh
    order drawn from the seed for every pass (``_deal``): every seed runs
    the same tasks and buckets in the same proportions, in another
    order."""
    mix = sorted(t["mix"].items())
    deck = [name for name, w in mix for _ in range(w)]
    rounds, pos = divmod(i, len(deck))
    order = _order(seed, "task", rounds, len(deck))
    task = deck[order[pos]]
    k = rounds * t["mix"][task] + sum(deck[o] == task for o in order[:pos])
    bi = _deal(seed, f"bucket-{task}",
               list(enumerate(bucket_deck(t, task))), k)
    return task, bi


def pretrain_batch(seed: int, step, t: Dict, device, force=None):
    """Step ``step`` of the pretraining mix ``t``: (its task, the batch of
    ``accum`` stacked micro-batches as device tensors, (text tokens,
    regions, prediction slots) of each row on the host).

    Steps 0 to len(``t["check"]``) - 1 are the check's, each a (task,
    bucket) of that list; later ones come from ``task_and_bucket``.
    ``force`` = (task, bucket index) fixes both (the warm-up's steps). A
    micro-batch's rows are drawn from ``bucket_rows`` of its task and
    bucket [Lt, Nb, B, M]: the rows the port's rule routes there. mlm and
    tlm mask each token but CLS and SEP with probability ``mask_prob`` (at
    least one): 80% the mask id, 10% a random id, 10% kept; vmlm masks
    regions so, zeroes their features and predicts a label-word id at
    each; itm draws its target 1 or 0 with probability 1/2. Slots: text
    ones at their index, region ones at Lt + index, M of them at most."""
    rng = np.random.default_rng(sub_seed(seed, "pretrain", step))
    n_check = len(t["check"])
    if force is not None:
        task, bi = force
    elif step < n_check:
        task, bi = t["check"][step]
    else:
        task, bi = task_and_bucket(seed, step - n_check, t)
    Lt, Nb, B, M = t["buckets"][bi]
    rows = bucket_rows(t, task)[bi]
    micro = [_pretrain_micro(rng, task, rows[rng.integers(0, len(rows), B)],
                             Lt, Nb, M, t)
             for _ in range(t["accum"])]
    host = {k: np.stack([m[0][k] for m in micro]) for k in micro[0][0]}
    lens = tuple(np.concatenate([m[1][i] for m in micro]) for i in range(3))
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "pretrain-feat", step))
    feat = torch.randn((t["accum"], B, Nb, t["img_dim"]), generator=gen,
                       device=device)
    keep = host.pop("_feat_keep")
    dev = {k: _to(v, device) for k, v in host.items()}
    dev["img_feat"] = feat.half().float() * _to(keep, device)[..., None]
    return task, dev, lens


def _order(seed, key, rounds, n):
    return np.random.default_rng(sub_seed(seed, key, rounds)).permutation(n)


def _deal(seed, key, weights, i):
    """Entry ``i`` of a deck holding each name of ``weights`` [(name,
    whole weight)] weight times, dealt in a new order from the seed for
    every pass through it."""
    deck = [name for name, w in weights for _ in range(w)]
    rounds, pos = divmod(i, len(deck))
    return deck[_order(seed, key, rounds, len(deck))[pos]]


def _pick(rng, valid, p):
    """Bool of ``valid``'s entries drawn with probability ``p``, at least
    one a row (each row has a valid entry)."""
    pick = valid & (rng.random(valid.shape) < p)
    none = ~pick.any(1)
    if none.any():
        score = rng.random(valid.shape) * valid
        pick[none, np.argmax(score[none], 1)] = True
    return pick


def _slots(pick, M):
    """(index [B, M], live [B, M]) of each row's first M picked entries."""
    order = np.argsort(~pick, axis=1, kind="stable")[:, :M]
    live = np.take_along_axis(pick, order, 1)
    return np.where(live, order, 0), live


def _pretrain_micro(rng, task, rows, Lt, Nb, M, t):
    V, first = t["vocab_size"], t["first_word_id"]
    cls, sep = t["cls_token_id"], t["sep_token_id"]
    B = len(rows)
    n1, nr = 2 * rows[:, 0], rows[:, 2]
    regions = np.arange(Nb)[None, :] < nr[:, None]
    # text: [CLS] words [SEP], or [CLS] lang1 [SEP] [SEP] lang2 [SEP]
    col = np.arange(Lt)[None, :]
    ids = rng.integers(first, V - 1, (B, Lt)).astype(np.int32)
    if task == "tlm":
        ids[(col == n1[:, None] + 1) | (col == n1[:, None] + 2)] = sep
    n_txt = _text_tokens(task, rows[:, 0], rows[:, 1])
    ids[:, 0] = cls
    ids[np.arange(B), n_txt - 1] = sep
    ids[col >= n_txt[:, None]] = t["pad_token_id"]
    mask = np.concatenate([col < n_txt[:, None], regions], 1).astype(np.int32)
    out = {"attn_mask": mask,
           "img_pos_feat": _boxes(rng, (B, Nb)) * regions[..., None]}
    img_masks = np.zeros((B, Nb), bool)
    n_slot = np.zeros(B, int)
    if task in ("mlm", "tlm"):
        words = (col > 0) & (col < n_txt[:, None] - 1) & (ids != sep)
        pick = _pick(rng, words, t["mask_prob"])
        idx, live = _slots(pick, M)
        labels = np.take_along_axis(ids, idx, 1)
        u = rng.random((B, Lt))
        rand = rng.integers(first, V - 1, (B, Lt))
        ids = np.where(pick & (u < 0.8), V - 1,
                       np.where(pick & (u < 0.9), rand, ids)).astype(np.int32)
        pos = idx
    elif task == "vmlm":
        img_masks = _pick(rng, regions, t["mask_prob"])
        idx, live = _slots(img_masks, M)
        labels = rng.integers(first, V - 1, (B, M))
        pos = Lt + idx
    if task == "itm":
        out["targets"] = (rng.random(B) < 0.5).astype(np.int32)
    else:
        n_slot = live.sum(1)
        out.update(masked_pos=np.where(live, pos, 0).astype(np.int32),
                   masked_weight=live.astype(np.float32),
                   txt_labels=np.where(live, labels, 0).astype(np.int32))
    if task == "vmlm":
        out["img_masks"] = img_masks
    out["input_ids"] = ids
    out["_feat_keep"] = (regions & ~img_masks).astype(np.float32)
    return out, (n_txt, nr, n_slot)
