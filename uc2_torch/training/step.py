"""The training step (port of uc2_tpu/training/step.py for the mlm family,
vmlm/mmxlm and itm).

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
    A = batch["input_ids"].shape[0]
    total = None
    for a in range(A):
        loss, m = loss_fn(model, {k: v[a] for k, v in batch.items()}, rng)
        loss.backward()
        total = m if total is None else {k: total[k] + m[k] for k in m}
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(A)
    return {k: v / A for k, v in total.items()}


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
