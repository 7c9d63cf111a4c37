"""Tensor parallelism over a model group (the reference's ``model`` mesh
axis, uc2_tpu/parallel/mesh.py ``_RULES``), written out Megatron-style.

The reference places its parameters with GSPMD and lets XLA insert the
collectives; its Pallas kernels have no partitioning rule, so they see
whole operands. Here one process drives one GPU, so the split is
explicit: ``shard_module`` cuts a whole model's parameters to this
process's shards (``models/convert.py`` ``tp_kind``: QKV and the FFN's
first dense column-parallel, the attention output and the FFN's second
dense row-parallel, the word table and the LM head's bias vocab-sharded),
and the layers call the collectives below. A step under ``--n_model T``
computes the step without it, up to the order of floating-point sums.

* ``copy_to_model``: identity forward, all-reduce backward (the input of a
  column-parallel product, whose gradient each process holds a part of);
* ``reduce_from_model``: all-reduce forward, identity backward (the
  partial outputs of a row-parallel product; every process then computes
  the same thing from the sum, so each keeps its own gradient);
* ``max_over_model``, ``sum_over_model``: the same without a gradient
  (the int8 serving products' maxima and exact integer sums);
* ``vocab_parallel_embedding``, ``vocab_parallel_rows``,
  ``vocab_parallel_cross_entropy``: the word table's lookup, the
  restricted decoder's rows and the LM head's CE over a vocabulary split
  by ``vocab_range``;
* ``full_state_dict`` / ``load_full_state_dict``: checkpoints hold the
  whole model, gathered over the model group, and are cut again on load.

Every collective is a plain ``torch.distributed`` call on the model group
(``mesh.model_group``), and each is the identity at one process a group.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from uc2_torch.models.convert import (gather_tensors, shard_state_dict,
                                      shard_tensor, tp_kind, vocab_range)
from uc2_torch.parallel import mesh as M


def tp_size() -> int:
    """Processes of this model group (1: no tensor parallelism)."""
    return M.model_count()


def tp_rank() -> int:
    return M.model_index()


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=M.model_group())
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """x; its gradient summed over the model group."""
    return x if tp_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """x summed over the model group; the gradient passed through."""
    return x if tp_size() == 1 else _ReduceFromModel.apply(x)


@torch.no_grad()
def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the model group (no gradient)."""
    x = x.detach().clone()
    return x if tp_size() == 1 else _all_reduce(x, dist.ReduceOp.MAX)


@torch.no_grad()
def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum over the model group (no gradient)."""
    x = x.detach().clone()
    return x if tp_size() == 1 else _all_reduce(x)


def _pieces(t: torch.Tensor, dim: int) -> List[torch.Tensor]:
    """Every process's ``t``, which may differ in size along ``dim`` only,
    in the model group's order (padded to the largest for the gather)."""
    dim = dim % t.dim()
    n = torch.full((1,), float(t.shape[dim]), device=t.device)
    sizes = [torch.empty_like(n) for _ in range(tp_size())]
    dist.all_gather(sizes, n, group=M.model_group())
    sizes = [int(s.item()) for s in sizes]
    pad = max(sizes) - t.shape[dim]
    if pad:
        t = torch.cat([t, t.new_zeros(*t.shape[:dim], pad,
                                      *t.shape[dim + 1:])], dim=dim)
    t = t.contiguous()
    bufs = [torch.empty_like(t) for _ in sizes]
    dist.all_gather(bufs, t, group=M.model_group())
    return [b.narrow(dim, 0, s) for b, s in zip(bufs, sizes)]


@torch.no_grad()
def gather_from_model(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model group's shards of ``t`` along ``dim`` concatenated (the
    vocab-sharded logits made whole); no gradient."""
    return t if tp_size() == 1 else torch.cat(_pieces(t, dim), dim=dim)


def vocab_owned(ids: torch.Tensor, vocab_size: int):
    """(mask of the ids this process's vocabulary shard holds, their rows
    in the shard, or 0 elsewhere)."""
    lo, hi = vocab_range(vocab_size, tp_rank(), tp_size())
    owned = (ids >= lo) & (ids < hi)
    return owned, torch.where(owned, ids - lo, 0)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             vocab_size: int) -> torch.Tensor:
    """``F.embedding(ids, whole table)`` from this process's rows
    ``weight`` of a vocabulary of ``vocab_size``: the owner of each id
    looks it up, the others give zeros, and the model group sums them (an
    exact sum: one term is not zero)."""
    owned, local = vocab_owned(ids, vocab_size)
    out = torch.where(owned[..., None], F.embedding(local, weight), 0.0)
    return reduce_from_model(out)


def vocab_parallel_rows(table: torch.Tensor, idx: torch.Tensor,
                        vocab_size: int, pick) -> torch.Tensor:
    """The rows ``idx`` (distinct) of the whole table from this process's
    shard ``table``: ``pick(table, rows)`` takes the rows it owns (a
    function with a gradient, ``heads.UniqueRows``), placed at their
    positions, zeros elsewhere, summed over the model group; the gradient
    of each row goes back to its owner."""
    owned, _ = vocab_owned(idx, vocab_size)
    sel = owned.nonzero()[:, 0]
    lo, _ = vocab_range(vocab_size, tp_rank(), tp_size())
    rows = pick(table, idx[sel] - lo)
    whole = rows.new_zeros((idx.shape[0], *table.shape[1:]))
    return reduce_from_model(whole.index_copy(0, sel, rows))


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 vocab_size: int, weights=None):
    """``heads.cross_entropy_with_logits`` over the vocabulary-sharded
    logits [..., V_m] (fp32) of a vocabulary of ``vocab_size``: the max
    and the sum of exponentials over the model group (two all-reduces), the
    gold logit from its owner (a third). Per element, times ``weights``
    when given; the same on every process of the group."""
    logits = logits.float()
    mx = max_over_model(logits.amax(dim=-1))
    total = reduce_from_model(torch.exp(logits - mx[..., None]).sum(-1))
    owned, local = vocab_owned(labels.long(), vocab_size)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    gold = reduce_from_model(torch.where(owned, gold, 0.0))
    loss = mx + torch.log(total) - gold
    return loss if weights is None else loss * weights


# ------------------------------------------------------------ the model
@torch.no_grad()
def shard_module(model: nn.Module, m: int, T: int) -> nn.Module:
    """Cut ``model``'s whole parameters to process ``m`` of ``T``'s shards
    in place (new ``nn.Parameter`` objects, each marked with its
    ``tp_kind``); a model already cut, or ``T`` 1, is left as it is.
    Raises by name when ``T`` does not divide the heads or the
    intermediate width."""
    if T == 1:
        return model
    cfg = getattr(model, "config", None)
    if cfg is not None and (cfg.num_attention_heads % T
                            or cfg.intermediate_size % T):
        raise ValueError(
            f"uc2_torch: --n_model {T} must divide the attention heads "
            f"({cfg.num_attention_heads}) and the intermediate width "
            f"({cfg.intermediate_size})")
    for name, p in list(model.named_parameters()):
        kind = tp_kind(name)
        if kind is None or getattr(p, "tp_kind", None):
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        new = nn.Parameter(shard_tensor(p.detach(), kind, m, T),
                           requires_grad=p.requires_grad)
        new.tp_kind = kind
        setattr(mod, leaf, new)
    return model


def is_sharded(p: torch.Tensor) -> bool:
    """Whether parameter ``p`` is a shard (``shard_module``)."""
    return getattr(p, "tp_kind", None) is not None


@torch.no_grad()
def gather_param(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The whole tensor of a shard ``t`` of ``kind`` (a parameter, or a
    moment of the optimizer shaped as it), gathered over the model group
    (a collective: every process calls it)."""
    return gather_tensors(_pieces(t, 1 if kind == "row" else 0), kind)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered whole: the state
    dict of the model without tensor parallelism (a collective under it,
    so every process of the group calls it)."""
    sd = model.state_dict()
    if tp_size() == 1:
        return sd
    return {k: (gather_param(v, tp_kind(k)) if tp_kind(k) else v)
            for k, v in sd.items()}


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor],
                         strict: bool = True):
    """Load a whole model's state dict (``full_state_dict``, or one written
    without tensor parallelism) into a model cut by ``shard_module``."""
    if tp_size() > 1:
        sd = shard_state_dict(sd, tp_rank(), tp_size())
    return model.load_state_dict(sd, strict=strict)


def place_model(model: nn.Module) -> nn.Module:
    """``model`` (whole, the same on every process) cut to this process's
    shards at its place on the grid, and every replica started from the
    first one's parameters (``mesh.broadcast_params``)."""
    shard_module(model, tp_rank(), tp_size())
    M.broadcast_params(model)
    return model
