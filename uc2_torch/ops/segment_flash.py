"""Segment-masked flash attention: the port's counterpart of jax's library
TPU kernel (``jax.experimental.pallas.ops.tpu.flash_attention``), which
the reference's ``_stock_flash_attention`` (uc2_tpu/ops/attention.py)
runs under ``use_pallas_attention="flash"``.

What the library kernel computes, and so what this module computes (it
reproduces the kernel, not the reference's docstring):

* the sequence is padded to Lp = ceil(L / 128) * 128 with zero keys and
  values; validity enters only as segment ids, 1 for a key whose additive
  bias is >= -1 and 0 for a masked or padded one, and no bias is added;
* s = (q.k^T) * (1 / sqrt(d)) in fp32, plus 0 where the query's and the
  key's segments agree and -0.7 * FLT_MAX where they do not. The mask
  value is finite: a query row whose first 128 keys are all masked carries
  m = -0.7 * FLT_MAX (every masked score rounds to exactly that) until the
  next block's rescale exp(m_prev - m_next) = 0 wipes the block out;
* an online softmax over 128-key blocks: m and l in fp32; p = exp(s - m)
  rounded to the value dtype *unnormalised* before P.V; acc <- acc *
  (alpha * l_prev / l_next) + (p.V) / l_next. With one block (Lp = 128)
  the kernel instead normalises p before rounding it;
* the output in q's dtype, and the rows' final m and l for the backward.

So a valid query row attends to the valid keys as the additive-bias
softmax does, and an invalid (segment 0) row attends to the other invalid
keys and to the Lp - L zero keys (score 0, value 0): at invalid rows the
result differs from ``xla_attention``. Valid rows give exactly zero weight
to invalid keys, so pooled outputs and losses see no difference.

The backward is the library kernel's: di = rowsum(o * dO) in fp32 from the
rounded output, p = exp(s - m) * (1 / l), dV = p^T (rounded) . dO,
dP = dO . v^T, dS = (dP - di) * p * scale, dK = dS^T (rounded) . q and
dQ = dS (rounded) . k. No gradient reaches the bias.

Kernels (``csrc/attention_segment.cu``): #12 the forward
(``segment_flash_fwd``), #12a dQ (``segment_flash_bwd_dq``, which also
computes di) and #12b dK/dV (``segment_flash_bwd_dkdv``, the training
attention's keys pass with the segment mask, ``csrc/attention_bwd.cuh``).
The padding is
virtual: the kernels read q, k, v as [B, L, n, 64] (views into the fused
QKV projection), count keys L..Lp-1 as zero keys of segment 0, and skip
query rows past L, which the reference computes and slices off (their
output gradient is 0, so they add nothing to dK and dV). The row
statistics are therefore [B, n, L]. Each wrapper launches its kernel on
CUDA tensors, counts the launch (``<wrapper>.launches``) and raises on
what the kernel does not take; on CPU tensors it runs the plain version
beside it, which walks the same 128-key blocks and rounds where the kernel
rounds.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from uc2_torch.ops import build
from uc2_torch.ops.flash_attention import (MAX_LEN, _check_len,
                                           check_device, check_heads,
                                           check_kernel_inputs,
                                           heads_row_stride)

BLOCK = 128                      # the library kernel's query and key block
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
VALID_BIAS = -1.0                # a key is valid where its bias is >= this


def padded_len(L: int) -> int:
    return -(-L // BLOCK) * BLOCK


def _segments(bias):
    """[B, L] bool: True (segment 1) where the additive bias is >= -1."""
    return bias[:, 0, 0, :] >= VALID_BIAS


def _padded(t, Lp):
    """[B, L, n, d] -> [B, Lp, n, d] with zero rows past L."""
    return F.pad(t, (0, 0, 0, 0, 0, Lp - t.shape[1]))


def _scores(q, k, bias):
    """Masked fp32 scores [B, n, L, Lp] of the L query rows against the Lp
    keys: (q.k^T) * scale, then + 0 or MASK_VALUE by segment."""
    B, L, n, d = q.shape
    Lp = padded_len(L)
    seg = _segments(bias)
    seg_k = F.pad(seg, (0, Lp - L), value=False)
    add = torch.where(seg[:, :, None] == seg_k[:, None, :],
                      torch.zeros((), device=q.device),
                      torch.full((), MASK_VALUE, device=q.device))
    s = torch.einsum("blnd,bmnd->bnlm", q.float(), _padded(k, Lp).float())
    return s * (1.0 / math.sqrt(d)) + add[:, None]


def segment_flash_plain(q, k, v, bias):
    """#12's function in plain PyTorch: (out [B, L, n, d] in q's dtype,
    stats [2, B, n, L] fp32 holding each row's final m and l)."""
    B, L, n, d = q.shape
    Lp = padded_len(L)
    s = _scores(q, k, bias)
    vp = _padded(v, Lp)
    if Lp == BLOCK:                      # the kernel's single-block path
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        l = e.sum(dim=-1)
        p = (e / l[..., None]).to(v.dtype).float()
        acc = torch.einsum("bnlm,bmnd->blnd", p, vp.float())
    else:
        m = torch.full((B, n, L), -math.inf, device=q.device)
        l = torch.zeros((B, n, L), device=q.device)
        acc = torch.zeros((B, L, n, d), device=q.device)
        for k0 in range(0, Lp, BLOCK):
            sj = s[..., k0:k0 + BLOCK]
            m_next = torch.maximum(m, sj.amax(dim=-1))
            p = torch.exp(sj - m_next[..., None])
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(dim=-1) + l_corr
            inv = torch.where(l_next == 0.0, torch.ones_like(l_next),
                              1.0 / l_next)
            pv = torch.einsum("bnlm,bmnd->blnd", p.to(v.dtype).float(),
                              vp[:, k0:k0 + BLOCK].float())
            acc = (acc * (l_corr * inv).transpose(1, 2)[..., None]
                   + pv * inv.transpose(1, 2)[..., None])
            m, l = m_next, l_next
    return acc.to(q.dtype), torch.stack([m, l])


def _probs(q, k, bias, stats):
    """p = exp(s - m) * (1 / l) from the forward's statistics, fp32
    [B, n, L, Lp]."""
    m, l = stats
    return torch.exp(_scores(q, k, bias) - m[..., None]) * (1.0 / l)[..., None]


def _ds(q, v, g, p, di):
    """dS = (dO . v^T - di) * p * scale, fp32 [B, n, L, Lp]."""
    Lp = p.shape[-1]
    dp = torch.einsum("blnd,bmnd->bnlm", g.float(), _padded(v, Lp).float())
    return (dp - di[..., None]) * p * (1.0 / math.sqrt(q.shape[-1]))


def segment_flash_bwd_dq_plain(q, k, v, bias, out, g, stats):
    """#12a's function in plain PyTorch: (dq [B, L, n, d] in q's dtype,
    di [B, n, L] fp32 = rowsum(out * g))."""
    di = (out.float() * g.float()).sum(dim=-1).transpose(1, 2)
    ds = _ds(q, v, g, _probs(q, k, bias, stats), di)
    Lp = ds.shape[-1]
    dq = torch.einsum("bnlm,bmnd->blnd", ds.to(q.dtype).float(),
                      _padded(k, Lp).float())
    return dq.to(q.dtype), di.contiguous()


def segment_flash_bwd_dkdv_plain(q, k, v, bias, g, stats, di):
    """#12b's function in plain PyTorch: (dk, dv) [B, L, n, d] in k's and
    v's dtypes, from the forward's statistics and #12a's di."""
    L = q.shape[1]
    p = _probs(q, k, bias, stats)
    dv = torch.einsum("bnlm,blnd->bmnd", p.to(g.dtype).float(), g.float())
    ds = _ds(q, v, g, p, di)
    dk = torch.einsum("bnlm,blnd->bmnd", ds.to(q.dtype).float(), q.float())
    return dk[:, :L].to(k.dtype), dv[:, :L].to(v.dtype)


# ---------------------------------------------------------------- wrappers
def _kernel_checks(what, q, k, v, bias, grads=()):
    """dtype, head width and length checks before a launch; returns the
    token stride of q, k and v."""
    check_kernel_inputs(what, bf16=(q, k, v, *grads), fp32=(bias,),
                        has_backward=True)
    _check_len(what, q.shape[3], q.shape[1], MAX_LEN)
    return heads_row_stride(q, k, v)


def _check_stats(what, stats, di, q):
    B, L, n, _ = q.shape
    if tuple(stats.shape) != (2, B, n, L) or stats.device != q.device:
        raise ValueError(f"{what}: stats must be [2, B, n, L] = "
                         f"{(2, B, n, L)} on {q.device}, got "
                         f"{tuple(stats.shape)} on {stats.device}")
    if di is not None and (tuple(di.shape) != (B, n, L)
                           or di.device != q.device):
        raise ValueError(f"{what}: di must be [B, n, L] = {(B, n, L)} on "
                         f"{q.device}")


def _check_grad(what, t, q):
    if t.shape != q.shape:
        raise ValueError(f"{what}: output and gradient must be "
                         f"{tuple(q.shape)}, got {tuple(t.shape)}")


def segment_flash_fwd(q, k, v, bias):
    """Kernel #12: q, k, v [B, L, n, d]; bias [B, 1, 1, L] additive fp32
    (only its sign pattern, bias >= -1, is read). Returns (out
    [B, L, n, d], stats [2, B, n, L] fp32), as ``segment_flash_plain``."""
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), "segment_flash_fwd")
    if dev.type == "cpu":
        return segment_flash_plain(q, k, v, bias)
    rs = _kernel_checks("segment_flash_fwd", q, k, v, bias)
    B, L, n, d = q.shape
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    stats = torch.empty((2, B, n, L), dtype=torch.float32, device=dev)
    build.launch("uc2_segment_flash_fwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 stats.data_ptr(), B, L, n, rs, 1.0 / math.sqrt(d),
                 device=dev)
    segment_flash_fwd.launches += 1
    return out, stats


segment_flash_fwd.launches = 0


def segment_flash_bwd_dq(q, k, v, bias, out, g, stats):
    """Kernel #12a: (dq [B, L, n, d], di [B, n, L] fp32) for the output
    gradient g, from the forward's output and statistics."""
    check_heads(q, k, v, bias)
    for t in (out, g):
        _check_grad("segment_flash_bwd_dq", t, q)
    dev = check_device((q, k, v, bias, out, g, stats), "segment_flash_bwd_dq")
    _check_stats("segment_flash_bwd_dq", stats, None, q)
    if dev.type == "cpu":
        return segment_flash_bwd_dq_plain(q, k, v, bias, out, g, stats)
    rs = _kernel_checks("segment_flash_bwd_dq", q, k, v, bias, (out, g))
    check_kernel_inputs("segment_flash_bwd_dq", fp32=(stats,),
                        has_backward=True)
    B, L, n, d = q.shape
    out, g = out.contiguous(), g.contiguous()
    dq = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    di = torch.empty((B, n, L), dtype=torch.float32, device=dev)
    if any(t.data_ptr() % 16 for t in (out, g)):
        raise ValueError("segment_flash_bwd_dq: the output and its gradient "
                         "must start on a 16-byte boundary (the kernel reads "
                         "them by TMA)")
    build.launch("uc2_segment_flash_bwd_dq", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(), g.data_ptr(),
                 stats.data_ptr(), dq.data_ptr(), di.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), device=dev)
    segment_flash_bwd_dq.launches += 1
    return dq, di


segment_flash_bwd_dq.launches = 0


def segment_flash_bwd_dkdv(q, k, v, bias, g, stats, di):
    """Kernel #12b: (dk, dv) [B, L, n, d] for the output gradient g, from
    the forward's statistics and #12a's di."""
    check_heads(q, k, v, bias)
    _check_grad("segment_flash_bwd_dkdv", g, q)
    dev = check_device((q, k, v, bias, g, stats, di),
                       "segment_flash_bwd_dkdv")
    _check_stats("segment_flash_bwd_dkdv", stats, di, q)
    if dev.type == "cpu":
        return segment_flash_bwd_dkdv_plain(q, k, v, bias, g, stats, di)
    rs = _kernel_checks("segment_flash_bwd_dkdv", q, k, v, bias, (g,))
    check_kernel_inputs("segment_flash_bwd_dkdv", fp32=(stats, di),
                        has_backward=True)
    B, L, n, d = q.shape
    g = g.contiguous()
    dk, dv = (torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
              for _ in range(2))
    if any(t.data_ptr() % 16 for t in (g, dk, dv)):
        raise ValueError("segment_flash_bwd_dkdv: the gradient and dk, dv "
                         "must start on a 16-byte boundary (the kernel reads "
                         "and writes them by TMA)")
    build.launch("uc2_segment_flash_bwd_dkdv", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                 stats.data_ptr(), di.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, L, n, rs, 1.0 / math.sqrt(d), device=dev)
    segment_flash_bwd_dkdv.launches += 1
    return dk, dv


segment_flash_bwd_dkdv.launches = 0


class _SegmentFlash(torch.autograd.Function):
    """Forward #12; backward #12a then #12b (no gradient for the bias)."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, stats = segment_flash_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, stats = ctx.saved_tensors
        dq, di = segment_flash_bwd_dq(q, k, v, bias, out, g, stats)
        dk, dv = segment_flash_bwd_dkdv(q, k, v, bias, g, stats, di)
        return dq, dk, dv, None


def segment_flash_attention(q, k, v, bias):
    """The library kernel's attention with its backward: q, k, v
    [B, L, n, d], bias [B, 1, 1, L] additive fp32. Returns [B, L, n, d] in
    q's dtype; kernels #12, #12a, #12b on CUDA tensors, their plain
    versions on CPU tensors."""
    return _SegmentFlash.apply(q, k, v, bias)
