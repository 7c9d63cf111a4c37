"""The training step and the validation step (port of
uc2_tpu/training/step.py).

``train_step`` runs forward, loss, backward and the optimizer update of
one batch, or of a stacked ``[A, B, ...]`` batch whose A micro-batches
are accumulated into one update (the reference's ``accumulated_grads``:
gradients and metrics are the mean over the micro-batches). Losses reduce
as the reference's: a flat mean over the unreduced loss elements (the
weighted sum over the prediction slots, or their elements, divided by
their count, at least 1), vmlm-soft and mmxlm-soft scaled by 1000, itm
over the padded batch rows, itm-ot as itm plus ``itm_ot_lambda`` times
the OT term, itm-rank (retrieval finetuning, a
``UC2ForImageTextRetrieval``) as the mean of the rank loss's
[groups, sample_size - 1] elements, vqa (VQA and VE, a ``UC2ForVqa``) as
the mean over the rows of the BCE elements' sum over the answers, and
nlvr2 (a ``UC2ForNlvr2``) as the mean of the examples' CE.

Across processes (``uc2_torch.parallel``) every count that divides a sum
is summed over the processes first (``mesh.global_count``), as the
reference divides by the global batch's counts, and ``train_step`` sums
the gradients and the metrics over them (``mesh.reduce_grads``, one
all-reduce) before the update: the step is the step on the concatenation
of the processes' batches. Each process's metrics are its share of the
global ones (its sums over the global counts; ``n_units`` its own count),
so their sums are the global metrics.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from uc2_torch.models.heads import cross_entropy_with_logits, \
    kl_div_with_logits
from uc2_torch.parallel.mesh import global_count, reduce_grads
from uc2_torch.training.optim import Optimizer

_MLM_TASKS = {"mlm": True, "tlm": True, "tlm-ni": False}  # task -> with_image
TASKS = tuple(_MLM_TASKS) + ("vmlm", "mmxlm", "vmlm-soft", "mmxlm-soft",
                             "mrfr", "mrm-nce", "mrc", "mrc-kl", "itm",
                             "itm-ot", "itm-rank", "vqa", "nlvr2")


def _clamp1(n):
    return torch.clamp(n, min=1.0)


def _mean(elems):
    """The sum of ``elems`` over their count across the processes, and that
    process's count."""
    n = torch.full((), float(elems.numel()), device=elems.device)
    return elems.sum() / _clamp1(global_count(n)), n


def make_loss_fn(task: str, valid_ids=None, itm_ot_lambda: float = 0.1,
                 ot_pos_only: bool = False,
                 sample_size: int = 0) -> Callable:
    """loss_fn(model, batch, rng) -> (scalar loss, metrics) for a
    ``UC2ForPretraining`` model (itm-rank: a ``UC2ForImageTextRetrieval``;
    vqa: a ``UC2ForVqa``; nlvr2: a ``UC2ForNlvr2``);
    ``rng`` None means deterministic. The task is the part of ``task``
    before its first "_" (one of ``TASKS``); ``valid_ids`` is the label
    vocabulary's token ids (the soft tasks); ``itm_ot_lambda`` and
    ``ot_pos_only`` shape itm-ot's loss; ``sample_size`` is itm-rank's
    rows a group."""
    base = task.split("_")[0]
    if base not in TASKS:
        raise ValueError(f"unknown task {task!r}")

    if base == "itm-rank" and sample_size < 2:
        raise ValueError("itm-rank needs the group's sample_size (>= 2)")

    def loss_fn(model, batch, rng):
        det = rng is None
        if base == "itm-rank":
            loss, n = _mean(model.rank_loss(batch, sample_size, det, rng))
            return loss, {"loss": loss.detach(), "n_units": n}
        if base in ("vqa", "nlvr2"):
            elems = model.loss(batch, det, rng)
            if base == "vqa":
                elems = elems.sum(-1)
            loss, n = _mean(elems)
            return loss, {"loss": loss.detach(), "n_units": n}
        if base in _MLM_TASKS:
            s, n = model.forward_mlm(batch, det, rng,
                                     with_image=_MLM_TASKS[base])
        elif base in ("vmlm", "mmxlm"):
            s, n = model.forward_mmxlm(batch, det, rng)
        elif base in ("vmlm-soft", "mmxlm-soft"):
            s, n = model.forward_mmxlm_soft(batch, valid_ids, det, rng)
            s = 1000.0 * s
        elif base == "mrfr":
            s, n = model.forward_mrfr(batch, det, rng)
        elif base == "mrm-nce":
            s, n, correct = model.forward_mrm_nce(batch, det, rng)
            n_all = _clamp1(global_count(n))
            loss = s / n_all
            return loss, {"loss": loss.detach(), "n_units": n.detach(),
                          "acc": (correct / n_all).detach()}
        elif base in ("mrc", "mrc-kl"):
            s, n = model.forward_mrc(batch, base == "mrc-kl", det, rng)
        else:
            s, b, ot = model.forward_itm(batch, det, rng,
                                         compute_ot=base == "itm-ot")
            n = torch.full((), float(b), device=s.device)
            if ot is None:
                xe = s / _clamp1(global_count(n))
                return xe, {"loss": xe.detach(), "n_units": n}
            pos = batch["targets"] == 1
            neg = batch["targets"] == 0
            n_all, n_pos, n_neg = global_count(n, pos.sum().float(),
                                               neg.sum().float())
            xe = s / _clamp1(n_all)
            s_pos = torch.where(pos, ot, 0.0).sum()
            s_neg = torch.where(neg, ot, 0.0).sum()
            if ot_pos_only:
                ot_loss = s_pos / _clamp1(n_pos)
            else:
                ot_loss = (s_pos - s_neg) / _clamp1(n_pos + n_neg)
            loss = xe + itm_ot_lambda * ot_loss
            return loss, {k: v.detach() for k, v in (
                ("loss", loss), ("xe", xe), ("ot", ot_loss),
                ("ot_pos", s_pos / _clamp1(n_pos)),
                ("ot_neg", s_neg / _clamp1(n_neg)), ("n_units", n))}
        loss = s / _clamp1(global_count(n))
        return loss, {"loss": loss.detach(), "n_units": n.detach()}

    return loss_fn


def is_stacked(batch) -> bool:
    """True when the batch carries a leading [accum] micro-batch axis."""
    return batch["input_ids"].dim() == 3


def accumulate_grads(loss_fn: Callable, model, batch, rng) -> Dict:
    """Leave in ``.grad`` the gradients of the loss of a plain batch, or
    their mean over the micro-batches of a stacked one; return the metrics
    (their mean likewise). The ``.grad`` fields must be None on entry."""
    if not is_stacked(batch):
        loss, metrics = loss_fn(model, batch, rng)
        loss.backward()
        return metrics
    return mean_grads(loss_fn, model, [
        ({k: v[a] for k, v in batch.items()}, rng)
        for a in range(batch["input_ids"].shape[0])])


def mean_grads(loss_fn: Callable, model, micro) -> Dict:
    """Leave in ``.grad`` the mean of the gradients of the micro-batches
    ``micro`` ([(batch, rng)], taken in order) and return the mean of
    their metrics. The ``.grad`` fields must be None on entry."""
    total = None
    for batch, rng in micro:
        loss, m = loss_fn(model, batch, rng)
        loss.backward()
        total = m if total is None else {k: total[k] + m[k] for k in m}
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(len(micro))
    return {k: v / len(micro) for k, v in total.items()}


def train_step(model, opt: Optimizer, batch: Dict[str, torch.Tensor], rng,
               task: str = "mlm", **loss_kw) -> Dict[str, torch.Tensor]:
    """One update of ``model`` by ``opt`` on ``batch`` (tensors on the
    model's device), with dropout drawn from ``rng`` (a ``DropoutRng``;
    None for a deterministic step). ``loss_kw`` goes to ``make_loss_fn``
    (``valid_ids``, ``itm_ot_lambda``, ``ot_pos_only``). Returns the loss
    function's metrics (``loss``, ``n_units``, ...) and ``grad_norm`` (the
    global norm of the unclipped gradients) as device tensors, so the step
    never waits for the card."""
    opt.zero_grad()
    metrics = accumulate_grads(make_loss_fn(task, **loss_kw), model, batch,
                               rng)
    metrics = reduce_grads(opt.params, metrics)
    metrics["grad_norm"] = opt.step()
    return metrics


def train_step_micro(model, opt: Optimizer, micro, task: str = "mlm",
                     **loss_kw) -> Dict[str, torch.Tensor]:
    """One update from micro-batches given one by one (``--host_accum``:
    their buckets may differ): ``micro`` is [(batch, rng)], and the
    gradients and metrics are the mean over them, as ``train_step`` takes
    them over a stacked batch."""
    opt.zero_grad()
    metrics = mean_grads(make_loss_fn(task, **loss_kw), model, micro)
    metrics = reduce_grads(opt.params, metrics)
    metrics["grad_norm"] = opt.step()
    return metrics


def _soft_ce(logits, t, w):
    """The KL elements' sum over the live slots."""
    return (kl_div_with_logits(logits, t, elementwise=True)
            * w[:, :, None]).sum()


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor], task: str,
              valid_ids=None) -> Dict[str, torch.Tensor]:
    """The deterministic validation forward of one batch: the sums the
    driver's ``validate`` adds up over a sweep, as device tensors (the
    reference's ``make_eval_step``):

    * the mlm family, vmlm/mmxlm and the soft tasks: ``loss`` (the CE, or
      the KL elements, summed over the live slots), ``n_correct`` (argmax
      hits; for the soft tasks the argmax of the target, on slots that
      have one) and ``n_word``;
    * mrfr: ``loss`` (squared error) and ``n_feat``; mrm-nce also
      ``n_correct``, ``l2_sum`` and ``cos_sum``; mrc/mrc-kl ``loss``,
      ``n_correct`` over the classes 1.. and ``n_feat``;
    * itm/itm-ot: ``loss``, ``n_correct`` and ``n_ex`` over the batch's
      real rows (``ex_mask``), and for itm-ot ``ot_pos``/``ot_neg`` (sums)
      and ``n_pos``/``n_neg`` over them."""
    base = task.split("_")[0]
    w = batch.get("masked_weight")
    if base in ("mlm", "tlm", "tlm-ni", "vmlm", "mmxlm"):
        if base in _MLM_TASKS:
            logits = model.forward_mlm(batch, True, None,
                                       with_image=_MLM_TASKS[base],
                                       compute_loss=False)
        else:
            logits = model.forward_mmxlm(batch, True, None,
                                         compute_loss=False)
        labels = batch["txt_labels"]
        loss = cross_entropy_with_logits(logits, labels, w).sum()
        correct = ((logits.argmax(-1) == labels) * w).sum()
        return {"loss": loss, "n_correct": correct, "n_word": w.sum()}
    if base in ("vmlm-soft", "mmxlm-soft"):
        logits = model.forward_mmxlm_soft(batch, valid_ids, True, None,
                                          compute_loss=False)
        t = batch["label_targets"]
        correct = ((logits.argmax(-1) == t.argmax(-1)) * w
                   * (t.sum(-1) > 0)).sum()
        return {"loss": _soft_ce(logits, t, w), "n_correct": correct,
                "n_word": w.sum()}
    if base == "mrfr":
        pred = model.forward_mrfr(batch, True, None, compute_loss=False)
        loss = ((pred - batch["feat_targets"].float()) ** 2
                * w[:, :, None]).sum()
        return {"loss": loss, "n_feat": w.sum()}
    if base == "mrm-nce":
        s, n, correct, l2, cos = model.forward_mrm_nce(batch, True, None,
                                                       with_stats=True)
        return {"loss": s, "n_correct": correct, "n_feat": n,
                "l2_sum": l2, "cos_sum": cos}
    if base in ("mrc", "mrc-kl"):
        logits = model.forward_mrc(batch, base == "mrc-kl", True, None,
                                   compute_loss=False)
        t = batch["label_targets"]
        labels = t[..., 1:].argmax(-1) + 1
        correct = (((logits[..., 1:].argmax(-1) + 1) == labels) * w).sum()
        loss = (_soft_ce(logits, t, w) if base == "mrc-kl" else
                cross_entropy_with_logits(logits, labels, w).sum())
        return {"loss": loss, "n_correct": correct, "n_feat": w.sum()}
    if base in ("itm", "itm-ot"):
        scores, ot = model.forward_itm(batch, True, None,
                                       compute_ot=base == "itm-ot",
                                       compute_loss=False)
        targets = batch["targets"]
        ex = batch.get("ex_mask")
        if ex is None:
            ex = torch.ones(scores.shape[0], device=scores.device)
        loss = (cross_entropy_with_logits(scores, targets) * ex).sum()
        correct = ((scores.argmax(-1) == targets) * ex).sum()
        out = {"loss": loss, "n_correct": correct, "n_ex": ex.sum()}
        if ot is not None:
            pos = (targets == 1) & (ex > 0)
            neg = (targets == 0) & (ex > 0)
            out.update(ot_pos=torch.where(pos, ot, 0.0).sum(),
                       ot_neg=torch.where(neg, ot, 0.0).sum(),
                       n_pos=pos.sum(), n_neg=neg.sum())
        return out
    raise ValueError(f"unknown task {task!r}")
