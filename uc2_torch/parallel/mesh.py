"""Data-parallel rules over the process group (the part of
uc2_tpu/parallel/mesh.py that survives in PyTorch: one process a GPU, each
with its own local batch).

* ``broadcast_params``: rank 0's parameters on every process at start (the
  reference's ``shard_params`` makes every host hold the same copy).
* ``global_count``: loss normalizers summed over the processes, so that a
  loss is its sum over the local batch divided by the count over the
  global one (the reference divides by the global batch's counts).
* ``reduce_grads``: one flat fp32 all-reduce (a sum) of every parameter's
  gradient, in a fixed order with zeros where a task left a gradient None,
  once an optimizer step after the micro-batches (the reference's psum);
  a few metrics ride at its end. With the global normalizers the summed
  gradient is the gradient of the loss over the concatenated batch.
* ``opt_partition``: ZeRO-1's ownership rule, the reference's
  ``opt_shardings``: a tensor is split over the processes along its first
  dimension that the world divides; one that no dimension fits stays
  whole on every process.

No ``DistributedDataParallel``: the task mix leaves different heads unused
from task to task, and one flat buffer of the same layout on every process
is deterministic and needs no ``find_unused_parameters``. Every function
here is a no-op without a process group; with one, even of one process,
it runs its collective.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from uc2_torch.parallel.multihost import is_initialized

ALIGN = 64      # elements: each tensor's slot in a flat buffer starts here


def flat_offsets(sizes: Sequence[int]) -> List[int]:
    """Offsets of tensors of ``sizes`` elements in a flat buffer, each
    aligned to ``ALIGN`` elements; the last entry is the buffer's size."""
    out, o = [], 0
    for n in sizes:
        out.append(o)
        o += -(-n // ALIGN) * ALIGN
    return out + [o]


def _all_reduce(t: torch.Tensor) -> None:
    """The sum over the processes, in place (one place to time it)."""
    dist.all_reduce(t)


def all_gather_flat(t: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``t`` (same shape everywhere), in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


@torch.no_grad()
def broadcast_params(model: torch.nn.Module, root: int = 0) -> None:
    """Every parameter and buffer of ``model`` as process ``root`` holds
    them, through one flat broadcast a dtype."""
    if not is_initialized():
        return
    tensors = list(model.parameters()) + list(model.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        offs = flat_offsets([t.numel() for t in group])
        flat = torch.zeros(offs[-1], dtype=dtype, device=group[0].device)
        for t, o in zip(group, offs):
            flat[o:o + t.numel()].copy_(t.reshape(-1))
        dist.broadcast(flat, src=root)
        for t, o in zip(group, offs):
            t.copy_(flat[o:o + t.numel()].view_as(t))


def global_count(*counts: torch.Tensor):
    """``counts`` (scalar tensors) summed over the processes, one
    all-reduce for all of them; as given without a process group."""
    if not is_initialized():
        return counts if len(counts) > 1 else counts[0]
    flat = torch.stack([c.detach().float() for c in counts])
    _all_reduce(flat)
    out = tuple(flat.unbind())
    return out if len(out) > 1 else out[0]


@torch.no_grad()
def reduce_grads(params: Sequence[torch.nn.Parameter],
                 metrics: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """Sum every parameter's ``.grad`` over the processes in one flat fp32
    all-reduce (a None gradient counts as zeros); afterwards each ``.grad``
    is a view of that buffer. ``metrics`` (scalar tensors) are summed in
    the same all-reduce and returned; as given without a process group."""
    if not is_initialized():
        return metrics
    names = list(metrics or {})
    sizes = [p.numel() for p in params] + [len(names)]
    offs = flat_offsets(sizes)
    dev = params[0].device
    flat = torch.zeros(offs[-1], dtype=torch.float32, device=dev)
    for p, o in zip(params, offs):
        if p.grad is not None:
            flat[o:o + p.numel()].copy_(p.grad.reshape(-1))
    tail = offs[len(params)]
    if names:
        flat[tail:tail + len(names)].copy_(torch.stack(
            [metrics[k].detach().float().reshape(()).to(dev)
             for k in names]))
    _all_reduce(flat)
    for p, o in zip(params, offs):
        p.grad = flat[o:o + p.numel()].view_as(p).to(p.dtype)
    if not names:
        return metrics
    return dict(zip(names, flat[tail:tail + len(names)].unbind()))


def opt_partition(shape: Sequence[int], n: int) -> Optional[int]:
    """ZeRO-1's ownership rule: the first dimension of ``shape`` that
    ``n`` processes divide (and that is at least ``n``), each process
    owning one contiguous ``1/n`` of it; None when no dimension fits (the
    tensor stays whole on every process)."""
    for axis, d in enumerate(shape):
        if d >= n and d % n == 0:
            return axis
    return None
