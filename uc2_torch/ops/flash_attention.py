"""Attention kernels (port of uc2_tpu/ops/flash_attention.py).

* ``flash_attention``: the inference forward, kernel in
  ``csrc/attention.cu``; its backward is the eager recompute through
  ``xla_attention``, as the reference's ``_fa_bwd``.
* ``flash_attention_train``: training attention with probs dropout inside
  the kernels, forward ``flash_attention_train_fwd`` and backward
  ``flash_attention_train_bwd`` (``csrc/attention_train.cu``). The
  dropout mask is Philox4x32-10 keyed on (seed, global score index)
  (``ops/philox.py``), so the backward redraws the forward's mask.

Each kernel wrapper launches its CUDA kernel on CUDA tensors and counts
the launch in ``<wrapper>.launches``; on CPU tensors it runs the plain
PyTorch version beside it (``flash_attention_plain``,
``flash_attention_train_plain``, ``flash_attention_train_bwd_plain``).
Any other input raises: there is no fallback from a CUDA tensor to a
plain version.
"""

from __future__ import annotations

import math

import torch

from uc2_torch.ops import build
from uc2_torch.ops.attention import xla_attention
from uc2_torch.ops.philox import check_seed, keep_mask, keep_threshold

HEAD_DIM = 64        # head width the kernels take
MAX_LEN = 512        # joint-length limit of the encoder
TRAIN_MAX_LEN = 256  # the training backward keeps dK, dV of every key on chip

flash_attention_plain = xla_attention


def check_heads(q, k, v, bias):
    """Shape checks shared by every attention wrapper: q, k, v [B, L, n, d]
    of one shape, bias [B, 1, 1, L]."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, L, n, d] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, L = q.shape[:2]
    if tuple(bias.shape) != (B, 1, 1, L):
        raise ValueError(f"bias must be [B, 1, 1, L] = {(B, 1, 1, L)}, got "
                         f"{tuple(bias.shape)}")


def check_device(tensors, what: str) -> torch.device:
    """All tensors on one device; returns it. Only CPU and CUDA tensors are
    taken: the CPU runs the plain version, CUDA the kernel."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: inputs are on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel and no plain version for "
                         f"device {dev}")
    return dev


def check_kernel_inputs(what: str, bf16=(), fp32=(), has_backward=False):
    """dtype checks before a CUDA launch; a kernel without a backward
    also refuses tensors that need a gradient."""
    for t in bf16:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the kernel takes bfloat16 activations "
                            f"and weights, got {t.dtype}")
    for t in fp32:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{what}: bias, LayerNorm and mask vectors must "
                            f"be contiguous float32, got {t.dtype}")
    if (not has_backward and torch.is_grad_enabled()
            and any(t.requires_grad for t in (*bf16, *fp32))):
        raise RuntimeError(f"{what}: the kernel has no backward; call it "
                           f"under torch.no_grad()")


def heads_row_stride(q, k, v) -> int:
    """Row stride (elements between tokens) of [B, L, n, 64] heads whose
    last two dims are dense, as in views into the fused QKV projection.
    Raises on layouts the kernels cannot read."""
    B, L, n, d = q.shape
    rs = q.stride(1)
    for t in (q, k, v):
        if (t.stride(3) != 1 or t.stride(2) != d or t.stride(1) != rs
                or (B > 1 and t.stride(0) != L * rs)):
            raise ValueError("heads must be [B, L, n, d] with dense heads "
                             "and one token stride shared by q, k and v")
        if t.data_ptr() % 16:
            raise ValueError("heads must start on a 16-byte boundary")
    if rs % 8:
        raise ValueError("the token stride of q, k, v must be a multiple of 8")
    return rs


def _check_len(what: str, d: int, L: int, limit: int):
    if d != HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head_dim {HEAD_DIM}, "
                         f"got {d}")
    if not 1 <= L <= limit:
        raise ValueError(f"{what}: the kernel takes joint lengths "
                         f"1..{limit}, got {L}")


# ------------------------------------------------------------- inference
def _flash_attention_kernel(q, k, v, bias):
    B, L, n, d = q.shape
    _check_len("flash_attention", d, L, MAX_LEN)
    rs = heads_row_stride(q, k, v)
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=q.device)
    build.launch("uc2_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), device=q.device)
    flash_attention.launches += 1
    return out


def _grads_of(fn, inputs, needs, g):
    """Gradients of fn(*inputs) against ``g`` for the inputs marked in
    ``needs`` (None for the others), by recomputing fn under autograd."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(bool(nd)) for x, nd in
              zip(inputs, needs)]
        out = fn(*xs)
        want = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, want, g) if want else ())
    return tuple(next(got) if x.requires_grad else None for x in xs)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, eager-recompute backward (the reference's
    ``_fa_bwd``: the vjp of ``_xla_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _flash_attention_kernel(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        return _grads_of(xla_attention, ctx.saved_tensors,
                         ctx.needs_input_grad, g)


def flash_attention(q, k, v, bias):
    """q, k, v [B, L, n, d]; bias [B, 1, 1, L] additive fp32.
    Returns softmax(q.k^T/sqrt(d) + bias).v as [B, L, n, d]."""
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), "flash_attention")
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, bias)
    check_kernel_inputs("flash_attention", bf16=(q, k, v), fp32=(bias,),
                        has_backward=True)
    return _FlashAttention.apply(q, k, v, bias)


flash_attention.launches = 0


# -------------------------------------------------------------- training
def _sum_dtype(t):
    """fp32 for bf16/fp16/fp32 inputs; float64 stays float64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _probs(q, k, bias):
    """Max-shifted softmax of q.k^T/sqrt(d) + bias in the sum dtype,
    [B, n, L, L]."""
    ct = _sum_dtype(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blnd,bmnd->bnlm", q.to(ct), k.to(ct))
    return torch.softmax(s * scale + bias.to(ct), dim=-1)


def _keep(seed, rate, q):
    B, L, n, _ = q.shape
    return keep_mask(seed, rate, B, n, L, L, q.device)


def _check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return rate


def flash_attention_train_plain(q, k, v, bias, seed: int, rate: float):
    """The training forward in plain PyTorch: fp32 probabilities P, then
    Pd = keep ? P/(1 - rate) : 0 in fp32, rounded to v's dtype, then
    Pd.v with fp32 sums, returned in v's dtype."""
    p = _probs(q, k, bias)
    if rate > 0.0:
        p = torch.where(_keep(seed, rate, q), p * (1.0 / (1.0 - rate)),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    ct = p.dtype
    ctx = torch.einsum("bnlm,bmnd->blnd", p.to(v.dtype).to(ct), v.to(ct))
    return ctx.to(v.dtype)


def flash_attention_train_bwd_plain(q, k, v, bias, seed: int, rate: float,
                                    g):
    """The reference kernel's backward formula in plain PyTorch: returns
    (dq, dk, dv, dbias) for the output gradient g [B, L, n, d].

    dV = Pd^T.g with Pd rounded to g's dtype; dP = keep ? (g.v^T)/(1 - rate)
    : 0; dS = P * (dP - sum_k dP * P); dS rounded to q's dtype, then
    dQ = dS.k * scale and dK = dS^T.q * scale; dbias = dS (fp32) summed
    over heads and queries."""
    B, L, _, d = q.shape
    scale = 1.0 / math.sqrt(d)
    p = _probs(q, k, bias)
    ct = p.dtype
    zero = torch.zeros((), dtype=ct, device=p.device)
    keep = _keep(seed, rate, q) if rate > 0.0 else None
    pd = p if keep is None else torch.where(keep, p * (1.0 / (1.0 - rate)),
                                            zero)
    dv = torch.einsum("bnlm,blnd->bmnd", pd.to(g.dtype).to(ct), g.to(ct))
    dp = torch.einsum("blnd,bmnd->bnlm", g.to(ct), v.to(ct))
    if keep is not None:
        dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), zero)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsl = ds.to(q.dtype).to(ct)
    dq = torch.einsum("bnlm,bmnd->blnd", dsl, k.to(ct)) * scale
    dk = torch.einsum("bnlm,blnd->bmnd", dsl, q.to(ct)) * scale
    db = ds.sum(dim=(1, 2)).reshape(B, 1, 1, L)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            db.to(bias.dtype))


def _train_kernel_checks(what, q, k, v, bias):
    check_kernel_inputs(what, bf16=(q, k, v), fp32=(bias,),
                        has_backward=True)
    _check_len(what, q.shape[3], q.shape[1], TRAIN_MAX_LEN)
    return heads_row_stride(q, k, v)


def flash_attention_train_fwd(q, k, v, bias, seed: int, rate: float):
    """Kernel #5: the training attention forward with probs dropout.
    q, k, v [B, L, n, d]; bias [B, 1, 1, L] fp32; ``seed`` a 32-bit int;
    ``rate`` in [0, 1). Returns [B, L, n, d] in v's dtype."""
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), "flash_attention_train_fwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        return flash_attention_train_plain(q, k, v, bias, seed, rate)
    rs = _train_kernel_checks("flash_attention_train_fwd", q, k, v, bias)
    B, L, n, d = q.shape
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    build.launch("uc2_attn_train_fwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), seed, keep_threshold(rate),
                 1.0 / (1.0 - rate), int(rate > 0.0), device=dev)
    flash_attention_train_fwd.launches += 1
    return out


flash_attention_train_fwd.launches = 0


def flash_attention_train_bwd(q, k, v, bias, seed: int, rate: float, g,
                              need_dbias: bool = True):
    """Kernel #6: the training attention backward, (dq, dk, dv, dbias) for
    the output gradient g [B, L, n, d]; dbias is None unless
    ``need_dbias``. The mask is redrawn from ``seed``."""
    check_heads(q, k, v, bias)
    if g.shape != q.shape:
        raise ValueError(f"g must be {tuple(q.shape)}, got {tuple(g.shape)}")
    dev = check_device((q, k, v, bias, g), "flash_attention_train_bwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        dq, dk, dv, db = flash_attention_train_bwd_plain(q, k, v, bias, seed,
                                                         rate, g)
        return dq, dk, dv, (db if need_dbias else None)
    rs = _train_kernel_checks("flash_attention_train_bwd", q, k, v, bias)
    check_kernel_inputs("flash_attention_train_bwd", bf16=(g,),
                        has_backward=True)
    B, L, n, d = q.shape
    g = g.contiguous()
    dq, dk, dv = (torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
                  for _ in range(3))
    dbp = (torch.empty((B, n, L), dtype=torch.float32, device=dev)
           if need_dbias else None)
    build.launch("uc2_attn_train_bwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), g.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 0 if dbp is None else dbp.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), seed, keep_threshold(rate),
                 1.0 / (1.0 - rate), int(rate > 0.0), device=dev)
    flash_attention_train_bwd.launches += 1
    db = None if dbp is None else dbp.sum(dim=1).reshape(B, 1, 1, L)
    return dq, dk, dv, db


flash_attention_train_bwd.launches = 0


class _FlashAttentionTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        ctx.save_for_backward(q, k, v, bias)
        return flash_attention_train_fwd(q, k, v, bias, seed, rate)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = flash_attention_train_bwd(
            q, k, v, bias, ctx.seed, ctx.rate, g,
            need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, db, None, None


def flash_attention_train(q, k, v, bias, seed: int, rate: float = 0.0):
    """Training attention: q, k, v [B, L, n, d], bias [B, 1, 1, L]
    additive fp32, ``seed`` a 32-bit int from which the dropout mask is
    drawn, ``rate`` the attention-probs dropout rate. Forward and backward
    are kernels #5 and #6 on CUDA tensors, their plain versions on CPU
    tensors; the backward returns dbias when the bias needs a gradient."""
    return _FlashAttentionTrain.apply(q, k, v, bias, check_seed(seed),
                                      _check_rate(rate))
