"""The training step and the validation step (port of
uc2_tpu/training/step.py for the mlm family, vmlm/mmxlm and itm).

``train_step`` runs forward, loss, backward and the optimizer update of
one batch, or of a stacked ``[A, B, ...]`` batch whose A micro-batches
are accumulated into one update (the reference's ``accumulated_grads``:
gradients and metrics are the mean over the micro-batches). Losses reduce
as the reference's: the weighted sum over the prediction slots divided by
max(n_slots, 1), and for itm the sum over the rows divided by the padded
batch size.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from uc2_torch.models.heads import cross_entropy_with_logits
from uc2_torch.training.optim import Optimizer

_MLM_TASKS = {"mlm": True, "tlm": True, "tlm-ni": False}  # task -> with_image


def make_loss_fn(task: str) -> Callable:
    """loss_fn(model, batch, rng) -> (scalar loss, metrics) for a
    ``UC2ForPretraining`` model; ``rng`` None means deterministic. Tasks:
    mlm, tlm, tlm-ni, vmlm and mmxlm (loss over the prediction slots) and
    itm (loss over the padded batch rows, as the reference reduces it)."""
    base = task.split("_")[0]
    if base in _MLM_TASKS:
        def forward(model, batch, rng):
            return model.forward_mlm(batch, deterministic=rng is None,
                                     rng=rng, with_image=_MLM_TASKS[base])
    elif base in ("vmlm", "mmxlm"):
        def forward(model, batch, rng):
            return model.forward_mmxlm(batch, deterministic=rng is None,
                                       rng=rng)
    elif base == "itm":
        def forward(model, batch, rng):
            s, b = model.forward_itm(batch, deterministic=rng is None,
                                     rng=rng)
            return s, torch.full((), float(b), device=s.device)
    else:
        raise NotImplementedError(f"uc2_torch: task {task!r} is not ported "
                                  f"yet (mlm, tlm, tlm-ni, vmlm, mmxlm and "
                                  f"itm are)")

    def loss_fn(model, batch, rng):
        s, n = forward(model, batch, rng)
        loss = s / torch.clamp(n, min=1.0)
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
               task: str = "mlm") -> Dict[str, torch.Tensor]:
    """One update of ``model`` by ``opt`` on ``batch`` (tensors on the
    model's device), with dropout drawn from ``rng`` (a ``DropoutRng``;
    None for a deterministic step). Returns ``loss``, ``n_units`` and
    ``grad_norm`` (the global norm of the unclipped gradients) as device
    tensors, so the step never waits for the card."""
    opt.zero_grad()
    metrics = accumulate_grads(make_loss_fn(task), model, batch, rng)
    metrics["grad_norm"] = opt.step()
    return metrics


def train_step_micro(model, opt: Optimizer, micro, task: str = "mlm"
                     ) -> Dict[str, torch.Tensor]:
    """One update from micro-batches given one by one (``--host_accum``:
    their buckets may differ): ``micro`` is [(batch, rng)], and the
    gradients and metrics are the mean over them, as ``train_step`` takes
    them over a stacked batch."""
    opt.zero_grad()
    metrics = mean_grads(make_loss_fn(task), model, micro)
    metrics["grad_norm"] = opt.step()
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              task: str) -> Dict[str, torch.Tensor]:
    """The deterministic validation forward of one batch: the sums the
    driver's ``validate`` adds up over a sweep, as device tensors. mlm,
    tlm, tlm-ni, vmlm and mmxlm give ``loss`` (the CE summed over the
    live slots), ``n_correct`` (argmax hits there) and ``n_word`` (the
    live slots); itm gives ``loss``, ``n_correct`` and ``n_ex`` over the
    batch's real rows (``ex_mask``), so a padded trailing batch counts
    its examples only."""
    base = task.split("_")[0]
    if base in ("mlm", "tlm", "tlm-ni", "vmlm", "mmxlm"):
        if base in _MLM_TASKS:
            logits = model.forward_mlm(batch, True, None,
                                       with_image=_MLM_TASKS[base],
                                       compute_loss=False)
        else:
            logits = model.forward_mmxlm(batch, True, None,
                                         compute_loss=False)
        labels, w = batch["txt_labels"], batch["masked_weight"]
        loss = cross_entropy_with_logits(logits, labels, w).sum()
        correct = ((logits.argmax(-1) == labels) * w).sum()
        return {"loss": loss, "n_correct": correct, "n_word": w.sum()}
    if base == "itm":
        scores, _ = model.forward_itm(batch, True, None, compute_loss=False)
        targets = batch["targets"]
        w = batch.get("ex_mask")
        if w is None:
            w = torch.ones(scores.shape[0], device=scores.device)
        loss = (cross_entropy_with_logits(scores, targets) * w).sum()
        correct = ((scores.argmax(-1) == targets) * w).sum()
        return {"loss": loss, "n_correct": correct, "n_ex": w.sum()}
    raise NotImplementedError(f"uc2_torch: validation of task {task!r} is "
                              f"not ported yet (mlm, tlm, tlm-ni, vmlm, "
                              f"mmxlm and itm are)")
