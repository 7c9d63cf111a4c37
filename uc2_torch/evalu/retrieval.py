"""Image-text retrieval evaluation (port of ``load_image_gallery``,
``default_nbb_buckets``, ``score_matrix``, ``full_retrieval_eval``,
``quick_validate`` and ``mine_hard_negatives`` from
uc2_tpu/evalu/retrieval.py).

The gallery is split into region-count buckets with the reference's
edges, padding and column order; each bucket is moved to the device once
and stays there while every text is scored against it, one batch of
``batch_size`` images at a time. Scores of a chunk of texts stay on the
device until one host pull per chunk. ``quick_validate`` ranks each
text's image among a fixed pool of images, and ``mine_hard_negatives``
takes the highest-scoring wrong images of each text and wrong texts of
each image; both rank a score matrix with functions of the matrix alone
(``pool_ranks``, ``hard_negative_pools``). Across processes
``full_retrieval_eval`` scores each process's stride of the texts and
gathers the rows into the whole matrix on every process.

Under a profiler ``score_matrix`` records its spans
(``uc2_torch.utils.profiling``): ``score.call`` around the call, counting
``pairs`` (captions x images) and ``slots`` (captions x tiles x batch
size, padding included); ``score.gallery``, the gallery's and the
captions' rows; ``score.upload``, a bucket's padded tiles put on the
device; ``score.chunk``, a chunk of captions queued against a bucket and
its one host pull.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from uc2_torch import resolve_device
from uc2_torch.data.datasets import ItmEvalDataset
from uc2_torch.evalu.itm_metrics import itm_eval
from uc2_torch.utils.profiling import count, span


def load_image_gallery(img_db, img_ids: Sequence[str], num_bb: int):
    """Pad the gallery to [n_img, Nb, D] (+ bb7, + per-image nbb)."""
    n = len(img_ids)
    feat0, _ = img_db[img_ids[0]]
    D = feat0.shape[1]
    feats = np.zeros((n, num_bb, D), np.float32)
    bb7 = np.zeros((n, num_bb, 7), np.float32)
    nbbs = np.zeros(n, np.int32)
    for j, im in enumerate(img_ids):
        f, b = img_db[im]
        k = min(f.shape[0], num_bb)
        feats[j, :k] = f[:k]
        bb7[j, :k] = b[:k]
        nbbs[j] = k
    return feats, bb7, nbbs


def default_nbb_buckets(txt_len: int, num_bb: int) -> tuple:
    """Gallery bucket edges: joint lengths of 128 and 256, plus 36 regions
    (the reference's edges, so both packages score the same buckets)."""
    edges = {e for e in (128 - txt_len, 256 - txt_len) if 0 < e < num_bb}
    edges.add(min(36, num_bb - 1) if num_bb > 36 else num_bb // 2)
    return tuple(sorted(e for e in edges if e > 0))


def bucket_edges(txt_len: int, num_bb: int,
                 nbb_buckets: Optional[Sequence[int]] = None) -> list:
    """Upper region-count edge of every bucket, the last one ``num_bb``."""
    if nbb_buckets is None:
        nbb_buckets = default_nbb_buckets(txt_len, num_bb)
    return [b for b in sorted(nbb_buckets) if b < num_bb] + [num_bb]


def _text_rows(txt_db, txt_ids, txt_len):
    txt_arr = np.full((len(txt_ids), txt_len), 1, np.int64)  # pad id 1
    txt_m = np.zeros((len(txt_ids), txt_len), np.int64)
    for i, tid in enumerate(txt_ids):
        ids = np.asarray(txt_db.combine_inputs(
            txt_db[tid]["input_ids"]))[:txt_len]
        txt_arr[i, :len(ids)] = ids
        txt_m[i, :len(ids)] = 1
    return txt_arr, txt_m


def _bucket_tiles(feats, bb7, nbbs, sel, nb, n_tiles, batch_size,
                  model_dev):
    """The bucket ``sel``'s features, boxes and region masks cut to ``nb``
    regions, padded to ``n_tiles`` tiles of ``batch_size`` images and put
    on ``model_dev`` as [n_tiles, batch_size, nb, ...]."""
    pad = n_tiles * batch_size - sel.size
    f = np.zeros((n_tiles * batch_size, nb, feats.shape[2]), np.float32)
    b7 = np.zeros((n_tiles * batch_size, nb, 7), np.float32)
    f[:sel.size] = feats[sel][:, :nb]
    b7[:sel.size] = bb7[sel][:, :nb]
    rmask = (np.arange(nb)[None, :]
             < np.concatenate([nbbs[sel], np.zeros(pad, np.int32)])[:, None])
    f_tiles = torch.from_numpy(f).to(model_dev).view(
        n_tiles, batch_size, nb, -1)
    b7_tiles = torch.from_numpy(b7).to(model_dev).view(
        n_tiles, batch_size, nb, 7)
    rm_tiles = torch.from_numpy(rmask.astype(np.int64)).to(
        model_dev).view(n_tiles, batch_size, nb)
    return f_tiles, b7_tiles, rm_tiles


def score_matrix(model, txt_db, img_db, txt_ids: Sequence[str],
                 img_ids: Sequence[str], txt_len: int, num_bb: int,
                 batch_size: int = 64,
                 nbb_buckets: Optional[Sequence[int]] = None,
                 txt_chunk: int = 8, device="cuda") -> np.ndarray:
    """[n_txt, n_img] rank scores of ``model`` (a
    ``UC2ForImageTextRetrieval`` whose parameters are on ``device``)."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"score_matrix: the model is on {model_dev}, not "
                         f"on {dev}")
    n_txt, n_img = len(txt_ids), len(img_ids)
    with span("score.call"):
        count("pairs", n_txt * n_img)
        with span("score.gallery"):
            feats, bb7, nbbs = load_image_gallery(img_db, img_ids, num_bb)
            txt_arr, txt_m = _text_rows(txt_db, txt_ids, txt_len)
            txt_arr = torch.from_numpy(txt_arr).to(model_dev)
            txt_m = torch.from_numpy(txt_m).to(model_dev)
        edges = bucket_edges(txt_len, num_bb, nbb_buckets)
        img_bucket = np.searchsorted(np.asarray(edges), nbbs)
        out = np.zeros((n_txt, n_img), np.float32)

        for bi, nb in enumerate(edges):
            sel = np.flatnonzero(img_bucket == bi)
            if sel.size == 0:
                continue
            n_tiles = -(-sel.size // batch_size)
            count("slots", n_txt * n_tiles * batch_size)
            with span("score.upload"):
                f_tiles, b7_tiles, rm_tiles = _bucket_tiles(
                    feats, bb7, nbbs, sel, nb, n_tiles, batch_size,
                    model_dev)
            for c0 in range(0, n_txt, txt_chunk):
                with span("score.chunk"):
                    rows = []
                    for i in range(c0, min(c0 + txt_chunk, n_txt)):
                        ids = txt_arr[i].expand(batch_size, txt_len)
                        tmask = txt_m[i].expand(batch_size, txt_len)
                        rows.append(torch.cat([model.scores({
                            "input_ids": ids, "img_feat": f_tiles[j],
                            "img_pos_feat": b7_tiles[j],
                            "attn_mask": torch.cat([tmask, rm_tiles[j]],
                                                   dim=1)})
                            for j in range(n_tiles)]))
                    s = torch.stack(rows).cpu().numpy()  # one pull a chunk
                    out[c0:c0 + len(rows), sel] = s[:, :sel.size]
    return out


def full_retrieval_eval(model, txt_db, img_db, txt_len: int, num_bb: int,
                        batch_size: int = 64,
                        txt_ids: Optional[Sequence[str]] = None,
                        return_matrix: bool = False, device="cuda"
                        ) -> Dict[str, float]:
    """Score-matrix eval -> R@K in both directions over
    ``ItmEvalDataset``'s texts and gallery. Process p of a group scores
    the texts p, p + world, ... and the rows are gathered into the whole
    matrix on every process (the reference's allgather of the score
    matrix); the columns keep the gallery's (region count, name) order
    everywhere. One process scores every text. Under tensor parallelism
    the texts are striped over the replicas (a model group scores one
    stripe together) and the gather keeps the first process of each
    group, so no row is counted twice."""
    from uc2_torch.parallel import mesh as M
    from uc2_torch.parallel import multihost as MH
    ev = ItmEvalDataset(txt_db, img_db, txt_ids)
    txt_ids, img_ids = ev.ids, ev.all_img_ids
    pos = list(range(M.data_index(), len(txt_ids), M.data_count()))
    mine = score_matrix(model, txt_db, img_db, [txt_ids[i] for i in pos],
                        img_ids, txt_len, num_bb, batch_size, device=device)
    m = np.zeros((len(txt_ids), len(img_ids)), np.float32)
    for rows, part in MH.all_gather_object((pos, mine))[::M.model_count()]:
        m[np.asarray(rows, np.int64)] = part
    metrics = itm_eval(m, txt_ids, img_ids, txt_db.txt2img, txt_db.img2txts)
    if return_matrix:
        return metrics, (m, txt_ids, img_ids)
    return metrics


def quick_validation_pool(txt_db, n_imgs: int = 400,
                          n_txts: Optional[int] = None, seed: int = 0):
    """(text ids, image pool) of ``quick_validate``: ``n_imgs`` images of
    the database drawn from ``seed`` (all when it has fewer), ``n_txts``
    texts likewise (all when None), the texts whose image is in the pool,
    and each text's image put into the pool in place of the first drawn
    images (one slot each), as the reference chooses them."""
    rng = np.random.default_rng(seed)
    txt2img = txt_db.txt2img
    pool = sorted({txt2img[t] for t in txt_db.ids})
    if len(pool) > n_imgs:
        pool = [pool[i] for i in rng.choice(len(pool), n_imgs,
                                            replace=False)]
    txt_ids = list(txt_db.ids)
    if n_txts is not None and len(txt_ids) > n_txts:
        txt_ids = [txt_ids[i] for i in rng.choice(len(txt_ids), n_txts,
                                                  replace=False)]
    in_pool = set(pool)
    txt_ids = [t for t in txt_ids if txt2img[t] in in_pool] or txt_ids[:1]
    slot = 0
    for t in txt_ids:
        gt = txt2img[t]
        if gt not in in_pool and slot < len(pool):
            in_pool.discard(pool[slot])
            pool[slot] = gt
            in_pool.add(gt)
            slot += 1
    return txt_ids, pool


def pool_ranks(m: np.ndarray, txt_ids: Sequence[str], pool: Sequence[str],
               txt2img: Dict[str, str]) -> Dict[str, float]:
    """Image R@1/5/10 and the median rank (from 1) of each text's image
    among ``pool`` in the score matrix ``m`` [texts, pool]: its rank is
    the count of images that score strictly higher."""
    img2j = {im: j for j, im in enumerate(pool)}
    ranks = np.asarray([int((m[i] > m[i, img2j[txt2img[t]]]).sum())
                        for i, t in enumerate(txt_ids)
                        if txt2img[t] in img2j])
    return {"img_r1": float((ranks < 1).mean()),
            "img_r5": float((ranks < 5).mean()),
            "img_r10": float((ranks < 10).mean()),
            "med_rank": float(np.median(ranks) + 1)}


def quick_validate(model, txt_db, img_db, txt_len: int, num_bb: int,
                   n_imgs: int = 400, n_txts: Optional[int] = None,
                   batch_size: int = 64, seed: int = 0,
                   device="cuda") -> Dict[str, float]:
    """Rank each text's image among a fixed pool of ``n_imgs`` images
    (``quick_validation_pool``): image R@1/5/10 and the median rank."""
    txt_ids, pool = quick_validation_pool(txt_db, n_imgs, n_txts, seed)
    m = score_matrix(model, txt_db, img_db, txt_ids, pool, txt_len, num_bb,
                     batch_size, device=device)
    return pool_ranks(m, txt_ids, pool, txt_db.txt2img)


def hard_negative_pools(m: np.ndarray, txt_ids: Sequence[str],
                        img_ids: Sequence[str], txt2img: Dict[str, str],
                        hard_neg_size: int) -> Dict[str, Dict[str, List[str]]]:
    """From the score matrix ``m`` [texts, images]: each text's
    ``hard_neg_size`` highest-scoring images other than its own
    (``txt2hardimgs``) and each image's highest-scoring texts other than
    its own (``img2hardtxts``), ties in index order (a stable sort)."""
    img2txts: Dict[str, set] = {}
    for t in txt_ids:
        img2txts.setdefault(txt2img[t], set()).add(t)
    txt2hardimgs = {}
    for i, tid in enumerate(txt_ids):
        gt = txt2img[tid]
        order = np.argsort(-m[i], kind="stable")
        txt2hardimgs[tid] = [img_ids[j] for j in order
                             if img_ids[j] != gt][:hard_neg_size]
    img2hardtxts = {}
    for j, img in enumerate(img_ids):
        own = img2txts.get(img, set())
        order = np.argsort(-m[:, j], kind="stable")
        img2hardtxts[img] = [txt_ids[i] for i in order
                             if txt_ids[i] not in own][:hard_neg_size]
    return {"txt2hardimgs": txt2hardimgs, "img2hardtxts": img2hardtxts}


def mine_hard_negatives(model, txt_db, img_db, txt_len: int, num_bb: int,
                        hard_neg_size: int = 20, batch_size: int = 64,
                        out_path: Optional[str] = None, device="cuda"
                        ) -> Dict[str, Dict[str, List[str]]]:
    """Hard-negative pools of ``hard_neg_size`` entries in both directions
    from the score matrix of every text of ``txt_db`` against every image
    they name (sorted by name); written as JSON to ``out_path`` when
    given."""
    txt2img = txt_db.txt2img
    txt_ids = list(txt_db.ids)
    img_ids = sorted({txt2img[t] for t in txt_ids})
    m = score_matrix(model, txt_db, img_db, txt_ids, img_ids, txt_len,
                     num_bb, batch_size, device=device)
    hard = hard_negative_pools(m, txt_ids, img_ids, txt2img, hard_neg_size)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(hard, f)
    return hard
