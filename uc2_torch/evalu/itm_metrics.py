"""Retrieval and NLVR2 metrics (numpy), copies of ``itm_eval`` and
``nlvr2_eval`` from uc2_tpu/evalu/itm_metrics.py: R@1/5/10 in both
directions and r_mean from an [n_txt x n_img] score matrix, with the same
tie and ordering semantics (top-10 by score, first-match rank); NLVR2's
accuracy and consistency.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def itm_eval(score_matrix: np.ndarray, txt_ids: Sequence[str],
             img_ids: Sequence[str], txt2img: Dict[str, str],
             img2txts: Dict[str, List[str]]) -> Dict[str, float]:
    """score_matrix [n_txt, n_img]; higher = better match."""
    score_matrix = np.asarray(score_matrix)
    n_txt, n_img = score_matrix.shape
    assert n_txt == len(txt_ids) and n_img == len(img_ids)
    k = min(10, n_img)

    # image retrieval: for each text, rank of its GT image
    img2j = {im: j for j, im in enumerate(img_ids)}
    # argsort descending, stable to mirror torch.topk's value ordering
    rank_txt = np.argsort(-score_matrix, axis=1, kind="stable")[:, :k]
    gt_j = np.asarray([img2j[txt2img[t]] for t in txt_ids])[:, None]
    hit = rank_txt == gt_j
    pos = np.where(hit.any(1), hit.argmax(1), 10)
    ir_r1 = float((pos < 1).mean())
    ir_r5 = float((pos < 5).mean())
    ir_r10 = float((pos < 10).mean())

    # text retrieval: for each image, best rank among its GT texts
    txt2i = {t: i for i, t in enumerate(txt_ids)}
    kt = min(10, n_txt)
    rank_img = np.argsort(-score_matrix, axis=0, kind="stable")[:kt, :]
    tr_r1 = tr_r5 = tr_r10 = 0
    for j, im in enumerate(img_ids):
        gt_is = {txt2i[t] for t in img2txts[im] if t in txt2i}
        ranks = [r for r, i in enumerate(rank_img[:, j]) if i in gt_is]
        rank = min([10] + ranks)
        tr_r1 += rank < 1
        tr_r5 += rank < 5
        tr_r10 += rank < 10
    tr_r1 /= n_img
    tr_r5 /= n_img
    tr_r10 /= n_img

    tr_mean = (tr_r1 + tr_r5 + tr_r10) / 3
    ir_mean = (ir_r1 + ir_r5 + ir_r10) / 3
    return {"txt_r1": tr_r1, "txt_r5": tr_r5, "txt_r10": tr_r10,
            "txt_r_mean": tr_mean, "img_r1": ir_r1, "img_r5": ir_r5,
            "img_r10": ir_r10, "img_r_mean": ir_mean,
            "r_mean": (tr_mean + ir_mean) / 2}


def nlvr2_eval(predictions: Dict[str, str],
               labels: Dict[str, str]) -> Dict[str, float]:
    """Accuracy and consistency of NLVR2 predictions (the official
    scorer's): identifiers have NLVR2's 'split-####-#-#' form, and a
    consistency group is the identifiers equal but for the third field
    (the pair index), which is blanked; a group counts when all its
    predictions are right."""
    correct = 0
    groups: Dict[str, List[bool]] = {}
    for ex_id, pred in predictions.items():
        ok = pred == labels[ex_id]
        correct += ok
        parts = ex_id.split("-")
        if len(parts) > 2:
            parts[2] = ""
        groups.setdefault("-".join(parts), []).append(bool(ok))
    n = max(len(predictions), 1)
    consistency = (sum(all(v) for v in groups.values())
                   / max(len(groups), 1))
    return {"acc": correct / n, "consistency": consistency}
