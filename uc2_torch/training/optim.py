"""Optimizer and learning-rate schedules (port of uc2_tpu/training/optim.py).

``build_optimizer`` gives the reference's optax chain
``clip_by_global_norm(grad_norm) -> scale_by_{adam,adamax} ->
add_decayed_weights(wd, mask=decay_mask) -> scale_by_learning_rate`` (for
adamw optax's ``adamw``, the same chain) over two parameter groups (decay,
and no decay on biases and LayerNorm parameters); ``build_xlmr_optimizer``
the reference's two-rate chain (the clip over every parameter, then
``multi_transform`` of that chain with the XLM-R rate on
``pretrained_mask``'s parameters and the main rate on the rest), four
groups. Both give the same update:

* the learning rate of update t is ``schedule(t)`` of the parameter's
  group, t counted from 0, as optax counts;
* clipping is optax's ``g / norm * max_norm`` when norm >= max_norm (no
  ``+ 1e-6`` as in ``torch.nn.utils.clip_grad_norm_``);
* the decay is decoupled: ``p - lr * (u + wd * p)`` with ``u`` adam's
  ``m_hat / (sqrt(v_hat) + eps)`` (adam and adamw: one algorithm, as in
  the reference) or adamax's ``m_hat / max(b2 * u_prev, |g| + eps)``.
  ``torch.optim.AdamW`` computes the first (its decay is decoupled);
  ``torch.optim.Adamax`` at weight decay 0 computes adamax's moments as
  optax's ``scale_by_adamax`` does (eps inside the max), and the decay is
  applied beside it, since Adamax's own ``weight_decay`` is coupled L2.

The update runs outside any kernel, in PyTorch's own optimizer code.

``zero1=True`` is ZeRO-1 over the process group (the reference's
``--zero1``, ``opt_shardings``): each process keeps the moments of only
the slice of each parameter that ``opt_partition`` gives it, clips with
the global norm of the fully reduced gradient, updates its slice and
all-gathers the parameters, all on ``all_reduce`` and ``all_gather``. The
update is elementwise, so the parameters equal the replicated run's bit
for bit. ``state_dict`` gathers the moments to whole tensors (every
process must enter it) and ``load_state_dict`` cuts this process's slice
out of them, so a checkpoint reads back under either layout and any
world size.

Under tensor parallelism (``uc2_torch/parallel/tensor.py``) a sharded
parameter's gradient, moments and update are its process's shard: the
global norm counts each shard's squares once over the model group and each
replicated parameter once, ZeRO-1 splits the shards over the data group,
and ``state_dict`` gathers the moments whole over the model group too
(``load_state_dict`` cuts them again), so a checkpoint holds the state of
the run without tensor parallelism.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

from uc2_torch.models.convert import shard_tensor
from uc2_torch.parallel import mesh as M
from uc2_torch.parallel import tensor as TP


# -------------------------------------------------------------- schedules
def warmup_linear(lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up to ``lr`` over ``warmup`` steps, then linear decay to
    0 at ``total``, floored at 1e-8."""
    def f(step):
        w = max(warmup, 1)
        warm = step / w
        decay = max(0.0, (total - step) / max(total - warmup, 1))
        return max(lr * (warm if step < warmup else decay), 1e-8)
    return f


def noam(lr: float, warmup: int) -> Callable:
    """Inverse-square-root schedule, floored at 1e-8."""
    def f(step):
        w = max(warmup, 1)
        mult = step / w if step <= w else (w ** 0.5) * max(step, 1.0) ** -0.5
        return max(lr * mult, 1e-8)
    return f


def constant(lr: float) -> Callable:
    return lambda step: lr


def vqa_schedule(lr: float, warm_int: int, decay_int: int, decay_start: int,
                 decay_rate: float) -> Callable:
    """MCAN staircase: 1/4, 1/2, 3/4 of lr over three warm-up intervals,
    then lr, decayed by ``decay_rate`` every ``decay_int`` steps from
    ``decay_start``; floored at 1e-8."""
    def f(step):
        if step < warm_int:
            mult = 0.25
        elif step < 2 * warm_int:
            mult = 0.5
        elif step < 3 * warm_int:
            mult = 0.75
        elif step >= decay_start:
            mult = decay_rate ** math.ceil((step - decay_start) / decay_int)
        else:
            mult = 1.0
        return max(lr * mult, 1e-8)
    return f


def get_lr_schedule(decay: str, lr: float, warmup_steps: int = 0,
                    num_train_steps: int = 0, **vqa_kw) -> Callable:
    """The schedule named by a config's ``decay`` field."""
    if decay == "linear":
        return warmup_linear(lr, warmup_steps, num_train_steps)
    if decay == "invsqrt":
        return noam(lr, warmup_steps)
    if decay == "constant":
        return constant(lr)
    if decay == "vqa":
        return vqa_schedule(lr, vqa_kw["warm_int"], vqa_kw["decay_int"],
                            vqa_kw["decay_st"], vqa_kw["decay_rate"])
    raise ValueError(f"unknown decay {decay}")


# ------------------------------------------------------------- param masks
_NO_DECAY = re.compile(r"(LayerNorm|layer_norm)")


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True where weight decay applies: every parameter except biases and
    LayerNorm parameters (the reference's rule on its tree paths, applied
    to the port's dotted names)."""
    return {n: not (n.rsplit(".", 1)[-1] == "bias" or _NO_DECAY.search(n))
            for n in names}


_PRE_LAYER = re.compile(r"^roberta\.layer\.(\d+)\.")


def pretrained_mask(names: Iterable[str],
                    load_layer: Optional[int] = None) -> Dict[str, bool]:
    """True for the parameters initialised from XLM-R, the group that
    ``build_xlmr_optimizer`` gives the XLM-R rate: the text embeddings
    (``roberta.embeddings.*``; not the image embeddings, not the token
    types) and the encoder layers up to ``load_layer`` (the reference's
    ``pretrained_mask`` on its tree paths, applied to the port's dotted
    names)."""
    def pre(n):
        if n.startswith("roberta.embeddings."):
            return True
        m = _PRE_LAYER.match(n)
        return (load_layer is not None and m is not None
                and int(m.group(1)) <= load_layer)
    return {n: pre(n) for n in names}


# -------------------------------------------------------------- optimizer
def global_norm(tensors, sharded=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device.
    ``sharded`` marks the tensors that are tensor-parallel shards: their
    squares are summed over the model group, the others' counted once."""
    norms = torch.stack(torch._foreach_norm([t.float() for t in tensors]))
    if TP.tp_size() == 1 or not any(sharded or ()):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(sharded, device=norms.device)
    sq = norms.square()
    part = TP.reduce_from_model(torch.where(mask, sq, 0.0).sum())
    return torch.sqrt(torch.where(mask, 0.0, sq).sum() + part)


class _Part:
    """Under ZeRO-1, the slice of one parameter that this process updates:
    ``size`` entries from ``lo`` along ``axis`` of ``param``. ``tensor`` is
    a view of the parameter where the slice is contiguous, else a copy
    taken before each update and gathered back after it."""

    def __init__(self, param, axis: int, lo: int, size: int):
        self.param, self.axis, self.lo, self.size = param, axis, lo, size
        sl = param.detach().narrow(axis, lo, size)
        self.view = sl.is_contiguous()
        self.tensor = sl if self.view else sl.clone()

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """This process's slice of ``t`` (a tensor of the parameter's
        shape), contiguous."""
        return t.narrow(self.axis, self.lo, self.size).contiguous()


class Optimizer:
    """Adam, AdamW or Adamax with decoupled, masked weight decay, global-norm
    clipping and a schedule, as the reference's optax chain. ``step()``
    consumes the ``.grad`` of every parameter (a parameter the loss did not
    reach gets a zero gradient, as JAX gives it) and returns the global
    norm of the unclipped gradients. With ``pre_lr_fn``, the parameters
    that ``pre_mask`` marks follow that schedule instead of
    ``learning_rate_fn``. With ``zero1``, ZeRO-1 over the process group
    (the module's docstring); the gradients must then already be summed
    over the processes (``mesh.reduce_grads``)."""

    def __init__(self, model: torch.nn.Module, learning_rate_fn: Callable,
                 weight_decay: float, betas: Sequence[float], eps: float,
                 grad_norm: float, optim: str = "adamw",
                 pre_lr_fn: Optional[Callable] = None,
                 pre_mask: Optional[Dict[str, bool]] = None,
                 zero1: bool = False):
        named = list(model.named_parameters())
        mask = decay_mask(n for n, _ in named)
        pre = pre_mask if pre_lr_fn is not None else {}
        self.params = [p for _, p in named]
        # {index: tp_kind} of the tensor-parallel shards
        self.shards = {i: p.tp_kind for i, p in enumerate(self.params)
                       if TP.is_sharded(p)}
        self.grad_norm = grad_norm
        self.count = 0
        self.optim = optim
        # the tensors torch's optimizer updates: each parameter, or under
        # ZeRO-1 the slice of it this process owns (a parameter the rule
        # leaves whole is updated whole on every process)
        self.parts: Dict[int, _Part] = {}
        if zero1:
            n, r = M.data_count(), M.data_index()
            for i, p in enumerate(self.params):
                axis = M.opt_partition(p.shape, n)
                if n > 1 and axis is not None:
                    size = p.shape[axis] // n
                    self.parts[i] = _Part(p, axis, r * size, size)
        target = {id(p): (self.parts[i].tensor if i in self.parts else p)
                  for i, p in enumerate(self.params)}
        # (schedule, decay) -> parameters; torch keeps the groups in this
        # order, and the schedules beside them (a state dict holds no
        # functions)
        groups, self.lr_fns = [], []
        for lr_fn, is_pre in ((learning_rate_fn, False), (pre_lr_fn, True)):
            for decays in (True, False):
                ps = [target[id(p)] for n, p in named if mask[n] == decays
                      and pre.get(n, False) == is_pre]
                if ps or not is_pre:
                    groups.append({"params": ps, "weight_decay":
                                   weight_decay if decays else 0.0})
                    self.lr_fns.append(lr_fn)
        # the index torch's state dict gives each parameter
        order = [id(t) for g in groups for t in g["params"]]
        self._index = {i: order.index(id(target[id(p)]))
                       for i, p in enumerate(self.params)}
        lr0 = learning_rate_fn(0)
        if optim == "adamax":
            # decay beside the update (Adamax's own is coupled L2)
            self.decoupled = [g["weight_decay"] for g in groups]
            for g in groups:
                g["weight_decay"] = 0.0
            self.opt = torch.optim.Adamax(groups, lr=lr0, betas=tuple(betas),
                                          eps=eps)
        else:
            self.decoupled = None
            self.opt = torch.optim.AdamW(groups, lr=lr0, betas=tuple(betas),
                                         eps=eps)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads, [i in self.shards
                                   for i in range(len(grads))])
        if self.grad_norm and self.grad_norm > 0:
            # optax: g if norm < max_norm else g / norm * max_norm
            clip = norm >= self.grad_norm
            div = torch.where(clip, norm, torch.ones_like(norm))
            mul = torch.where(clip, torch.full_like(norm, self.grad_norm),
                              torch.ones_like(norm))
            for g in grads:
                g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
        for part in self.parts.values():
            if not part.view:
                part.tensor.copy_(part.own(part.param.detach()))
            part.tensor.grad = part.own(part.param.grad)
        for i, group in enumerate(self.opt.param_groups):
            group["lr"] = lr = float(self.lr_fns[i](self.count))
            if self.decoupled and self.decoupled[i] and group["params"]:
                # p - lr * wd * p, from the parameters before the update,
                # as torch's AdamW decays
                torch._foreach_mul_(group["params"],
                                    1.0 - lr * self.decoupled[i])
        self.opt.step()
        if self.parts:
            for part in self.parts.values():
                part.tensor.grad = None
            self._gather_params()
        self.count += 1
        return norm

    def _gather(self, pieces: Dict[int, torch.Tensor]):
        """{parameter index: its whole tensor} from this process's slices
        ``pieces`` (the parts' shapes) through one flat all-gather; every
        process calls it with the same indices."""
        idx = sorted(pieces)
        offs = M.flat_offsets([pieces[i].numel() for i in idx])
        first = pieces[idx[0]]
        flat = torch.zeros(offs[-1], dtype=first.dtype, device=first.device)
        for i, o in zip(idx, offs):
            flat[o:o + pieces[i].numel()].copy_(pieces[i].reshape(-1))
        bufs = M.all_gather_flat(flat)
        out = {}
        for i, o in zip(idx, offs):
            shape = pieces[i].shape
            out[i] = torch.cat([b[o:o + pieces[i].numel()].view(shape)
                                for b in bufs], dim=self.parts[i].axis)
        return out

    def _gather_params(self):
        """Every process's updated slices written into the parameters."""
        for i, whole in self._gather({i: pt.tensor for i, pt in
                                      self.parts.items()}).items():
            self.parts[i].param.detach().copy_(whole)

    def state_dict(self) -> Dict:
        """The update count (the schedule's step), the algorithm and its
        state: step counts and both moments of every parameter
        (``exp_avg`` and ``exp_avg_sq``, or Adamax's ``exp_inf``), whole
        under ZeRO-1 and tensor parallelism too (a collective: every
        process must call it)."""
        sd = self.opt.state_dict()
        if (self.parts or self.shards) and sd["state"]:
            state = {k: dict(v) for k, v in sd["state"].items()}
            keys = sorted({k for i in self.parts for k, v in
                           state[self._index[i]].items()
                           if torch.is_tensor(v) and v.dim() > 0})
            for k in keys:
                whole = self._gather({i: state[self._index[i]][k]
                                      for i in self.parts})
                for i, t in whole.items():
                    state[self._index[i]][k] = t
            for i, kind in self.shards.items():
                st = state.get(self._index[i], {})
                for k, v in sorted(st.items()):
                    if torch.is_tensor(v) and v.dim() > 0:
                        st[k] = TP.gather_param(v, kind)
            sd = dict(sd, state=state)
        return {"count": self.count, "optim": self.optim, "state": sd}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore what ``state_dict`` captured (whole moments, from any
        layout); the moments move to the parameters' device, and under
        ZeRO-1 this process keeps its slice."""
        if sd["optim"] != self.optim:
            raise ValueError(f"optimizer state of {sd['optim']!r}, not "
                             f"{self.optim!r}")
        self.count = int(sd["count"])
        inner = sd["state"]
        if (self.parts or self.shards) and inner["state"]:
            state = {k: dict(v) for k, v in inner["state"].items()}
            for i, kind in self.shards.items():
                st = state.get(self._index[i], {})
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        st[k] = shard_tensor(v, kind, TP.tp_rank(),
                                             TP.tp_size())
            for i, part in self.parts.items():
                st = state.get(self._index[i], {})
                for k, v in st.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        st[k] = part.own(v).clone()
            inner = dict(inner, state=state)
        self.opt.load_state_dict(inner)


def build_optimizer(model: torch.nn.Module, learning_rate_fn: Callable,
                    weight_decay: float = 0.01,
                    betas: Sequence[float] = (0.9, 0.98),
                    eps: float = 1e-6, grad_norm: float = -1.0,
                    optim: str = "adamw", zero1: bool = False) -> Optimizer:
    """Adam, AdamW or Adamax (``optim``) with decoupled decay, biases and
    LayerNorm exempt from it, and optional global-norm clipping (the
    reference's ``build_optimizer``); ``zero1`` shards its state over the
    process group."""
    if optim not in ("adam", "adamax", "adamw"):
        raise ValueError(f"invalid optimizer {optim!r}")
    return Optimizer(model, learning_rate_fn, weight_decay, betas, eps,
                     grad_norm, optim, zero1=zero1)


def build_xlmr_optimizer(model: torch.nn.Module, learning_rate_fn: Callable,
                         xlmr_lr_fn: Callable, weight_decay: float = 0.01,
                         betas: Sequence[float] = (0.9, 0.98),
                         eps: float = 1e-6, grad_norm: float = -1.0,
                         load_layer: Optional[int] = None,
                         optim: str = "adamw",
                         zero1: bool = False) -> Optimizer:
    """Two learning rates (the reference's ``build_xlmr_optimizer``, behind
    ``--separate_lr``): ``xlmr_lr_fn`` on the parameters initialised from
    XLM-R (``pretrained_mask``), ``learning_rate_fn`` on the rest, each
    with the decay groups of ``build_optimizer``; the clip is taken over
    every parameter first."""
    if optim not in ("adam", "adamax", "adamw"):
        raise ValueError(f"invalid optimizer {optim!r}")
    pre = pretrained_mask((n for n, _ in model.named_parameters()),
                          load_layer)
    return Optimizer(model, learning_rate_fn, weight_decay, betas, eps,
                     grad_norm, optim, pre_lr_fn=xlmr_lr_fn, pre_mask=pre,
                     zero1=zero1)
