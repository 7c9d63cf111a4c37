"""The process grid and the data-parallel rules over it (the part of
uc2_tpu/parallel/mesh.py that survives in PyTorch: one process a GPU, each
with its own local batch).

* ``init_grid(n_model)``: the world as ``n_data x n_model`` processes, as
  the reference's ``make_mesh`` reshapes its devices: process r sits at
  (d, m) = (r // n_model, r % n_model), so a model group (the processes
  that share one model's shards, ``uc2_torch/parallel/tensor.py``) is
  ``n_model`` consecutive ranks and a data group the ranks of one m.
  Without ``init_grid`` (or at ``n_model`` 1) the data group is the whole
  world. The processes of a model group read the same batch and draw the
  same dropout seeds; everything below runs over the data group.

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

# the grid of this process's group: the size of a model group, and this
# process's model and data groups (None: the world, or no group). It lays
# out the process group, which is itself one a process
_GRID = {"n_model": 1, "model": None, "data": None}


def _world():
    return dist.get_world_size() if is_initialized() else 1


def _rank():
    return dist.get_rank() if is_initialized() else 0


def init_grid(n_model: int = 1) -> None:
    """Split the process group into model groups of ``n_model`` consecutive
    ranks and data groups of the ranks at one place in them (every process
    calls it, after the group starts). Raises by name when ``n_model`` does
    not divide the world, or exceeds one without a process group."""
    reset_grid()
    n_model = int(n_model)
    world, rank = _world(), _rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"uc2_torch: --n_model {n_model} does not divide "
                         f"the {world} processes")
    _GRID["n_model"] = n_model
    if n_model == 1:
        return
    # every process creates every group, in one order
    for d in range(world // n_model):
        g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
        if d == rank // n_model:
            _GRID["model"] = g
    for m in range(n_model):
        g = dist.new_group(list(range(m, world, n_model)))
        if m == rank % n_model:
            _GRID["data"] = g


def reset_grid() -> None:
    """Back to one model group of one process (``multihost.shutdown``)."""
    _GRID.update(n_model=1, model=None, data=None)


def model_count() -> int:
    """Processes of a model group (``--n_model``)."""
    return _GRID["n_model"]


def model_index() -> int:
    """This process's place in its model group."""
    return _rank() % _GRID["n_model"]


def model_group():
    return _GRID["model"]


def data_count() -> int:
    """Processes of a data group: the number of model replicas."""
    return _world() // _GRID["n_model"]


def data_index() -> int:
    """This process's replica: the index of its model group."""
    return _rank() // _GRID["n_model"]


def data_group():
    return _GRID["data"]


def data_shard():
    """(replica, replicas) when there are several, else None: the stripe of
    the training data this process reads (a model group reads one)."""
    return (data_index(), data_count()) if data_count() > 1 else None


def flat_offsets(sizes: Sequence[int]) -> List[int]:
    """Offsets of tensors of ``sizes`` elements in a flat buffer, each
    aligned to ``ALIGN`` elements; the last entry is the buffer's size."""
    out, o = [], 0
    for n in sizes:
        out.append(o)
        o += -(-n // ALIGN) * ALIGN
    return out + [o]


def _all_reduce(t: torch.Tensor) -> None:
    """The sum over the data group, in place (one place to time it)."""
    dist.all_reduce(t, group=data_group())


def all_gather_flat(t: torch.Tensor) -> List[torch.Tensor]:
    """Every replica's ``t`` (same shape everywhere), in the data group's
    order."""
    out = [torch.empty_like(t) for _ in range(data_count())]
    dist.all_gather(out, t, group=data_group())
    return out


@torch.no_grad()
def broadcast_params(model: torch.nn.Module) -> None:
    """Every parameter and buffer of ``model`` as the first replica holds
    them (each process of a model group its own shards), through one flat
    broadcast a dtype over the data group."""
    if not is_initialized():
        return
    root = model_index()    # the global rank of replica 0 at this place
    tensors = list(model.parameters()) + list(model.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        offs = flat_offsets([t.numel() for t in group])
        flat = torch.zeros(offs[-1], dtype=dtype, device=group[0].device)
        for t, o in zip(group, offs):
            flat[o:o + t.numel()].copy_(t.reshape(-1))
        dist.broadcast(flat, src=root, group=data_group())
        for t, o in zip(group, offs):
            t.copy_(flat[o:o + t.numel()].view_as(t))


def global_count(*counts: torch.Tensor):
    """``counts`` (scalar tensors) summed over the replicas (the data
    group: a model group's processes count the same batch), one
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
    """Sum every parameter's ``.grad`` over the replicas (the data group)
    in one flat fp32 all-reduce (a None gradient counts as zeros): a
    sharded parameter's gradient is its shard's, a replicated one's the
    same on every process of a model group. Afterwards each ``.grad``
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
