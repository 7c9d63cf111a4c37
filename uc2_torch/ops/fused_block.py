"""Fused inference blocks of the encoder layer (port of
uc2_tpu/ops/fused_block.py ``fused_attn_block`` and ``fused_ffn_block``).

* ``fused_attn_block``: LayerNorm(x + attention(q, k, v, bias).Wo^T + bo),
  kernel in ``csrc/fused_attn_block.cu`` (wgmma and TMA; two blocks a
  64-row query tile, each with six heads and half the output columns,
  sharing the heads' contexts through distributed shared memory);
* ``fused_attn_block_v2``: the same block with the QKV projection inside
  the kernel (the reference's ``UC2_ATTN_V2`` route), kernel in
  ``csrc/fused_attn_block_v2.cu`` (#2's pieces in a cluster over a batch
  row's query tiles, each tile's K_h and V_h projected once and shared);
* ``fused_ffn_block``: LayerNorm(gelu(x.W1^T + b1).W2^T + b2 + x) (erf gelu),
  kernel in ``csrc/fused_ffn_block.cu`` (wgmma and TMA; two blocks a 64-row
  tile, each with half the output columns, sharing the GELU tiles through
  distributed shared memory); the [rows, F] intermediate never reaches
  device memory;
* ``fused_layer_block``: the whole encoder layer from the projected heads
  (the attention block, then the FFN block on its fp32 output), kernel in
  ``csrc/fused_layer_block.cu`` (the attention block's half and the FFN
  block's walk in one cluster of two blocks a 64-row query tile, the fp32
  output of the first LayerNorm kept in registers as the FFN's residual).
  Its gate is off, as the reference's: only the kernel lab
  (``uc2_torch/lab.py --mode layer``) runs it.

Under tensor parallelism (``uc2_torch/parallel/tensor.py``) #2, #7 and #3
run in a partial mode on a process's shard: ``fused_attn_block_partial``
(its heads and Wo's matching input columns), ``fused_attn_block_v2_partial``
(the same with its heads' rows of the QKV weight) and
``fused_ffn_block_partial`` (its intermediate columns) write the fp32
partial products without bias, residual or LayerNorm; the caller sums them
over the model group and applies ``block_epilogue``, which is the kernels'
epilogue in PyTorch.

Weights are in ``nn.Linear`` layout ([out, in]). Each wrapper launches its
kernel on CUDA tensors and counts the launch (``<wrapper>.launches``); on
CPU tensors it runs the plain version beside it. The plain versions round
where the kernels round (probabilities and context to the compute dtype,
the GELU output to x's dtype) and accumulate in fp32, so on bf16 inputs
they are a tight reference for the kernels.

The gates are copied unchanged from the reference package, so the
port routes the same kernels at the same shapes. They were measured on a
TPU; whether they pay on an H100 is still to be measured.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from uc2_torch.ops import build
from uc2_torch.ops.attention import xla_attention
from uc2_torch.ops.flash_attention import (HEAD_DIM, MAX_LEN, check_device,
                                           check_heads, check_kernel_inputs,
                                           heads_row_stride)

HIDDEN = 768       # hidden width the fused kernels take (uc2-base)
FFN_CHUNK = 64     # the FFN kernels walk the intermediate in these chunks


def layer_norm_f32(y, gamma, beta, eps):
    """LayerNorm of fp32 ``y`` with two-pass statistics, as the kernels."""
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()


def _attn_block_f32(q, k, v, bias, x, wo, bo, gamma, beta, eps):
    """LayerNorm(x + ctx.wo^T + bo) in fp32, the context rounded to wo's
    dtype."""
    B, L, n, d = q.shape
    ctx = xla_attention(q, k, v, bias).to(wo.dtype).reshape(B, L, n * d)
    y = ctx.float() @ wo.float().t() + bo.float() + x.float()
    return layer_norm_f32(y, gamma, beta, eps)


def _ffn_block_f32(x, res, w1, b1, w2, b2, gamma, beta, eps):
    """LayerNorm(gelu(x.W1^T + b1).W2^T + b2 + res) in fp32 (erf gelu), the
    GELU output rounded to x's dtype."""
    h = F.gelu(x.float() @ w1.float().t() + b1.float()).to(x.dtype)
    y = h.float() @ w2.float().t() + b2.float() + res
    return layer_norm_f32(y, gamma, beta, eps)


def fused_attn_block_plain(q, k, v, bias, x, wo, bo, gamma, beta,
                           eps: float = 1e-12):
    return _attn_block_f32(q, k, v, bias, x, wo, bo, gamma, beta,
                           eps).to(x.dtype)


def fused_attn_block(q, k, v, bias, x, wo, bo, gamma, beta,
                     eps: float = 1e-12):
    """One encoder attention block, fused.

    q, k, v [B, L, n, d] post-projection heads; bias [B, 1, 1, L] additive
    mask; x [B, L, H] block input (residual); wo [H, H] ([out, in]), bo [H];
    gamma, beta [H] LayerNorm affine. Returns LayerNorm(x + ctx.wo^T + bo)
    as [B, L, H] in x's dtype.
    """
    check_heads(q, k, v, bias)
    B, L, n, d = q.shape
    H = n * d
    if (tuple(x.shape) != (B, L, H) or tuple(wo.shape) != (H, H)
            or any(tuple(p.shape) != (H,) for p in (bo, gamma, beta))):
        raise ValueError(f"fused_attn_block: x must be [B, L, {H}], wo "
                         f"[{H}, {H}] and bo, gamma, beta [{H}]")
    dev = check_device((q, k, v, bias, x, wo, bo, gamma, beta),
                       "fused_attn_block")
    if dev.type == "cpu":
        return fused_attn_block_plain(q, k, v, bias, x, wo, bo, gamma, beta,
                                      eps)
    check_kernel_inputs("fused_attn_block", bf16=(q, k, v, x, wo),
                        fp32=(bias, bo, gamma, beta))
    if d != HEAD_DIM or H != HIDDEN:
        raise ValueError(f"fused_attn_block: the kernel takes head_dim "
                         f"{HEAD_DIM} and hidden {HIDDEN}, got {d}, {H}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"fused_attn_block: the kernel takes joint lengths "
                         f"1..{MAX_LEN}, got {L}")
    if not (x.is_contiguous() and wo.is_contiguous()):
        raise ValueError("fused_attn_block: x and wo must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, wo)):
        raise ValueError("fused_attn_block: x and wo must start on a 16-byte "
                         "boundary (the kernel reads them by TMA)")
    rs = heads_row_stride(q, k, v)
    out = torch.empty_like(x)
    build.launch("uc2_fused_attn_block", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), x.data_ptr(), wo.data_ptr(),
                 bo.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), B, L, n, rs, 1.0 / math.sqrt(d), float(eps),
                 device=dev)
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def block_epilogue(y, b, x, gamma, beta, eps: float = 1e-12):
    """LayerNorm((y + b) + x) of the fp32 sum ``y`` of the partial
    products, in fp32 with two-pass statistics, as #2's and #3's epilogue
    computes it; returned in x's dtype."""
    return layer_norm_f32(y + b.float() + x.float(), gamma, beta,
                          eps).to(x.dtype)


def fused_attn_block_partial_plain(q, k, v, bias, wo):
    """#2's partial mode in plain PyTorch: ctx . wo^T in fp32, the context
    rounded to wo's dtype."""
    B, L, n, d = q.shape
    ctx = xla_attention(q, k, v, bias).to(wo.dtype).reshape(B, L, n * d)
    return ctx.float() @ wo.float().t()


def fused_attn_block_partial(q, k, v, bias, wo):
    """#2's partial mode, for a tensor-parallel shard of the heads: q, k, v
    [B, L, n, d] (n of the layer's heads); bias [B, 1, 1, L] additive
    mask; wo [H, n * d] ([out, in], Wo's input columns of these heads).
    Returns the fp32 partial ctx . wo^T [B, L, H]: its sum over the shards
    plus bo and the residual, normalised (``block_epilogue``), is
    ``fused_attn_block``'s output."""
    check_heads(q, k, v, bias)
    B, L, n, d = q.shape
    H = wo.shape[0]
    if wo.dim() != 2 or wo.shape[1] != n * d:
        raise ValueError(f"fused_attn_block_partial: wo must be [H, {n * d}]"
                         f", got {tuple(wo.shape)}")
    dev = check_device((q, k, v, bias, wo), "fused_attn_block_partial")
    if dev.type == "cpu":
        return fused_attn_block_partial_plain(q, k, v, bias, wo)
    check_kernel_inputs("fused_attn_block_partial", bf16=(q, k, v, wo),
                        fp32=(bias,))
    if d != HEAD_DIM or H != HIDDEN or n * d > HIDDEN:
        raise ValueError(f"fused_attn_block_partial: the kernel takes "
                         f"head_dim {HEAD_DIM}, at most {HIDDEN // HEAD_DIM} "
                         f"heads and hidden {HIDDEN}, got {d}, {n}, {H}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"fused_attn_block_partial: the kernel takes joint "
                         f"lengths 1..{MAX_LEN}, got {L}")
    if not wo.is_contiguous() or wo.data_ptr() % 16:
        raise ValueError("fused_attn_block_partial: wo must be contiguous "
                         "and start on a 16-byte boundary (TMA)")
    rs = heads_row_stride(q, k, v)
    out = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    build.launch("uc2_fused_attn_block_partial", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), wo.data_ptr(), out.data_ptr(),
                 B, L, n, rs, 1.0 / math.sqrt(d), device=dev)
    fused_attn_block_partial.launches += 1
    return out


fused_attn_block_partial.launches = 0


def fused_attn_block_v2_plain(x, w_qkv, b_qkv, bias, wo, bo, gamma, beta,
                              n: int, eps: float = 1e-12):
    """#7's function: q, k, v = bf16(fp32(x.W^T) + b) (the bias is added in
    fp32 before rounding, unlike the eager chain's Dense), then as
    ``fused_attn_block_plain``."""
    B, L, H = x.shape
    qkv = (x.float() @ w_qkv.float().t() + b_qkv.float()).to(x.dtype)
    q, k, v = (t.reshape(B, L, n, H // n) for t in qkv.split(H, dim=-1))
    return fused_attn_block_plain(q, k, v, bias, x, wo, bo, gamma, beta, eps)


def fused_attn_block_v2(x, w_qkv, b_qkv, bias, wo, bo, gamma, beta, n: int,
                        eps: float = 1e-12):
    """One encoder attention block with the QKV projection in the kernel
    (kernel #7): x [B, L, H] block input; w_qkv [3H, H] ([out, in], the
    rows of q, then k, then v; head h's at rows h*d .. h*d + d - 1 of
    each), b_qkv [3H]; bias [B, 1, 1, L] additive mask; wo [H, H], bo [H];
    gamma, beta [H]; n heads. Returns LayerNorm(x + attention.wo^T + bo) as
    [B, L, H] in x's dtype; the [B, L, 3H] projection never reaches device
    memory.
    """
    if x.dim() != 3:
        raise ValueError(f"fused_attn_block_v2: x must be [B, L, H], got "
                         f"{tuple(x.shape)}")
    B, L, H = x.shape
    if (tuple(w_qkv.shape) != (3 * H, H)
            or tuple(b_qkv.shape) != (3 * H,) or tuple(wo.shape) != (H, H)
            or tuple(bias.shape) != (B, 1, 1, L)
            or any(tuple(p.shape) != (H,) for p in (bo, gamma, beta))
            or H % n):
        raise ValueError(f"fused_attn_block_v2: w_qkv must be [3H, H], "
                         f"b_qkv [3H], bias [B, 1, 1, L], wo [H, H] and bo, "
                         f"gamma, beta [H], with H = {H} a multiple of n = "
                         f"{n}")
    dev = check_device((x, w_qkv, b_qkv, bias, wo, bo, gamma, beta),
                       "fused_attn_block_v2")
    if dev.type == "cpu":
        return fused_attn_block_v2_plain(x, w_qkv, b_qkv, bias, wo, bo, gamma,
                                         beta, n, eps)
    check_kernel_inputs("fused_attn_block_v2", bf16=(x, w_qkv, wo),
                        fp32=(b_qkv, bias, bo, gamma, beta))
    if H // n != HEAD_DIM or H != HIDDEN:
        raise ValueError(f"fused_attn_block_v2: the kernel takes head_dim "
                         f"{HEAD_DIM} and hidden {HIDDEN}, got {H // n}, {H}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"fused_attn_block_v2: the kernel takes joint "
                         f"lengths 1..{MAX_LEN}, got {L}")
    if not all(t.is_contiguous() for t in (x, w_qkv, wo)):
        raise ValueError("fused_attn_block_v2: x, w_qkv and wo must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (x, w_qkv, wo)):
        raise ValueError("fused_attn_block_v2: x, w_qkv and wo must start on "
                         "a 16-byte boundary (the kernel reads them by TMA)")
    out = torch.empty_like(x)
    build.launch("uc2_fused_attn_block_v2", x.data_ptr(), w_qkv.data_ptr(),
                 b_qkv.data_ptr(), bias.data_ptr(), wo.data_ptr(),
                 bo.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), B, L, n, 1.0 / math.sqrt(HEAD_DIM),
                 float(eps), device=dev)
    fused_attn_block_v2.launches += 1
    return out


fused_attn_block_v2.launches = 0


def fused_attn_block_v2_partial_plain(x, w_qkv, b_qkv, bias, wo, n: int):
    """#7's partial mode in plain PyTorch: q, k, v = bf16(fp32(x.W^T) + b)
    for the shard's n heads, then ``fused_attn_block_partial_plain``."""
    B, L, _ = x.shape
    nd = w_qkv.shape[0] // 3
    qkv = (x.float() @ w_qkv.float().t() + b_qkv.float()).to(x.dtype)
    q, k, v = (t.reshape(B, L, n, nd // n) for t in qkv.split(nd, dim=-1))
    return fused_attn_block_partial_plain(q, k, v, bias, wo)


def fused_attn_block_v2_partial(x, w_qkv, b_qkv, bias, wo, n: int):
    """#7's partial mode, for a tensor-parallel shard of the heads: x
    [B, L, H] the whole block input; w_qkv [3 n d, H] and b_qkv [3 n d]
    the shard's rows in ``shard_tensor``'s "qkv" layout (q of its n heads,
    then k, then v); bias [B, 1, 1, L] additive mask; wo [H, n d] ([out,
    in], Wo's input columns of these heads). Returns the fp32 partial
    ctx . wo^T [B, L, H]: its sum over the shards plus bo and the
    residual, normalised (``block_epilogue``), is ``fused_attn_block_v2``'s
    output. The [B, L, 3 n d] projection never reaches device memory."""
    if x.dim() != 3:
        raise ValueError(f"fused_attn_block_v2_partial: x must be [B, L, H], "
                         f"got {tuple(x.shape)}")
    B, L, H = x.shape
    nd = wo.shape[1] if wo.dim() == 2 else -1
    if (n < 1 or nd % n or tuple(wo.shape) != (H, nd)
            or tuple(w_qkv.shape) != (3 * nd, H)
            or tuple(b_qkv.shape) != (3 * nd,)
            or tuple(bias.shape) != (B, 1, 1, L)):
        raise ValueError(f"fused_attn_block_v2_partial: wo must be [H, n d], "
                         f"w_qkv [3 n d, H], b_qkv [3 n d] and bias "
                         f"[B, 1, 1, L] for n = {n} heads, got "
                         f"{tuple(wo.shape)}, {tuple(w_qkv.shape)}, "
                         f"{tuple(b_qkv.shape)}, {tuple(bias.shape)}")
    dev = check_device((x, w_qkv, b_qkv, bias, wo),
                       "fused_attn_block_v2_partial")
    if dev.type == "cpu":
        return fused_attn_block_v2_partial_plain(x, w_qkv, b_qkv, bias, wo, n)
    check_kernel_inputs("fused_attn_block_v2_partial", bf16=(x, w_qkv, wo),
                        fp32=(b_qkv, bias))
    if nd // n != HEAD_DIM or H != HIDDEN or nd > HIDDEN:
        raise ValueError(f"fused_attn_block_v2_partial: the kernel takes "
                         f"head_dim {HEAD_DIM}, at most {HIDDEN // HEAD_DIM} "
                         f"heads and hidden {HIDDEN}, got {nd // n}, {n}, "
                         f"{H}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"fused_attn_block_v2_partial: the kernel takes "
                         f"joint lengths 1..{MAX_LEN}, got {L}")
    if not all(t.is_contiguous() for t in (x, w_qkv, wo)):
        raise ValueError("fused_attn_block_v2_partial: x, w_qkv and wo must "
                         "be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w_qkv, wo)):
        raise ValueError("fused_attn_block_v2_partial: x, w_qkv and wo must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "by TMA)")
    out = torch.empty((B, L, H), dtype=torch.float32, device=dev)
    build.launch("uc2_fused_attn_block_v2_partial", x.data_ptr(),
                 w_qkv.data_ptr(), b_qkv.data_ptr(), bias.data_ptr(),
                 wo.data_ptr(), out.data_ptr(), B, L, n,
                 1.0 / math.sqrt(HEAD_DIM), device=dev)
    fused_attn_block_v2_partial.launches += 1
    return out


fused_attn_block_v2_partial.launches = 0


def fused_ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, eps: float = 1e-12):
    return _ffn_block_f32(x, x.float(), w1, b1, w2, b2, gamma, beta,
                          eps).to(x.dtype)


def fused_ffn_block(x, w1, b1, w2, b2, gamma, beta, eps: float = 1e-12):
    """Fused FFN block: LayerNorm(gelu(x.W1^T + b1).W2^T + b2 + x).

    x [..., H]; w1 [F, H], w2 [H, F] ([out, in]); b1 [F]; b2, gamma, beta
    [H]. Returns [..., H] in x's dtype.
    """
    H = x.shape[-1]
    Fi = w1.shape[0]
    if (tuple(w1.shape) != (Fi, H) or tuple(w2.shape) != (H, Fi)
            or tuple(b1.shape) != (Fi,)
            or any(tuple(p.shape) != (H,) for p in (b2, gamma, beta))):
        raise ValueError(f"fused_ffn_block: w1 must be [F, {H}], w2 "
                         f"[{H}, F], b1 [F] and b2, gamma, beta [{H}]")
    dev = check_device((x, w1, b1, w2, b2, gamma, beta), "fused_ffn_block")
    if dev.type == "cpu":
        return fused_ffn_block_plain(x, w1, b1, w2, b2, gamma, beta, eps)
    check_kernel_inputs("fused_ffn_block", bf16=(x, w1, w2),
                        fp32=(b1, b2, gamma, beta))
    if H != HIDDEN or Fi % FFN_CHUNK or not Fi:
        raise ValueError(f"fused_ffn_block: the kernel takes hidden {HIDDEN} "
                         f"and an intermediate width that is a positive "
                         f"multiple of {FFN_CHUNK}, got {H}, {Fi}")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("fused_ffn_block: x, w1 and w2 must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("fused_ffn_block: x, w1 and w2 must start on a "
                         "16-byte boundary (the kernel reads them by TMA)")
    out = torch.empty_like(x)
    if x.numel():
        build.launch("uc2_fused_ffn_block", x.data_ptr(), w1.data_ptr(),
                     b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                     gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                     x.numel() // H, Fi, float(eps), device=dev)
        fused_ffn_block.launches += 1
    return out


fused_ffn_block.launches = 0


def fused_ffn_block_partial_plain(x, w1, b1, w2):
    """#3's partial mode in plain PyTorch: bf16(gelu(x . w1^T + b1)) .
    w2^T in fp32 (erf gelu, the GELU output rounded to x's dtype)."""
    h = F.gelu(x.float() @ w1.float().t() + b1.float()).to(x.dtype)
    return h.float() @ w2.float().t()


def fused_ffn_block_partial(x, w1, b1, w2):
    """#3's partial mode, for a tensor-parallel shard of the intermediate:
    x [..., H]; w1 [F, H] and b1 [F] (F of the intermediate's columns),
    w2 [H, F] ([out, in]). Returns the fp32 partial gelu(x . w1^T + b1) .
    w2^T [..., H]: its sum over the shards plus b2 and the residual,
    normalised (``block_epilogue``), is ``fused_ffn_block``'s output."""
    H = x.shape[-1]
    Fi = w1.shape[0]
    if (tuple(w1.shape) != (Fi, H) or tuple(w2.shape) != (H, Fi)
            or tuple(b1.shape) != (Fi,)):
        raise ValueError(f"fused_ffn_block_partial: w1 must be [F, {H}], w2 "
                         f"[{H}, F] and b1 [F]")
    dev = check_device((x, w1, b1, w2), "fused_ffn_block_partial")
    if dev.type == "cpu":
        return fused_ffn_block_partial_plain(x, w1, b1, w2)
    check_kernel_inputs("fused_ffn_block_partial", bf16=(x, w1, w2),
                        fp32=(b1,))
    if H != HIDDEN or Fi % FFN_CHUNK or not Fi:
        raise ValueError(f"fused_ffn_block_partial: the kernel takes hidden "
                         f"{HIDDEN} and an intermediate shard that is a "
                         f"positive multiple of {FFN_CHUNK}, got {H}, {Fi}")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("fused_ffn_block_partial: x, w1 and w2 must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("fused_ffn_block_partial: x, w1 and w2 must start "
                         "on a 16-byte boundary (the kernel reads them by "
                         "TMA)")
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if x.numel():
        build.launch("uc2_fused_ffn_block_partial", x.data_ptr(),
                     w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     out.data_ptr(), x.numel() // H, Fi, device=dev)
        fused_ffn_block_partial.launches += 1
    return out


fused_ffn_block_partial.launches = 0


def fused_layer_block_plain(q, k, v, bias, x, wo, bo, g1, be1, w1, b1, w2,
                            b2, g2, be2, eps: float = 1e-12):
    """#8's function, rounding where the reference's ``_layer_kernel``
    rounds: x2 = the attention block's fp32 LayerNorm output, the FFN's
    input bf16(x2) (x's dtype), and its residual x2 in fp32. So it is not
    ``fused_ffn_block_plain(fused_attn_block_plain(...))``, whose FFN adds
    the attention block's rounded output."""
    x2 = _attn_block_f32(q, k, v, bias, x, wo, bo, g1, be1, eps)
    return _ffn_block_f32(x2.to(x.dtype), x2, w1, b1, w2, b2, g2, be2,
                          eps).to(x.dtype)


def fused_layer_block(q, k, v, bias, x, wo, bo, g1, be1, w1, b1, w2, b2, g2,
                      be2, eps: float = 1e-12):
    """One whole encoder layer, fused (kernel #8): q, k, v [B, L, n, d]
    post-projection heads; bias [B, 1, 1, L] additive mask; x [B, L, H]
    the layer's input; wo [H, H], w1 [F, H], w2 [H, F] ([out, in]); bo, g1,
    be1, b2, g2, be2 [H]; b1 [F]. Returns
    LN2(gelu(bf16(x2).w1^T + b1).w2^T + b2 + x2), x2 = LN1(x + ctx.wo^T +
    bo) in fp32, as [B, L, H] in x's dtype.
    """
    check_heads(q, k, v, bias)
    B, L, n, d = q.shape
    H, Fi = n * d, w1.shape[0]
    if (tuple(x.shape) != (B, L, H) or tuple(wo.shape) != (H, H)
            or tuple(w1.shape) != (Fi, H) or tuple(w2.shape) != (H, Fi)
            or tuple(b1.shape) != (Fi,)
            or any(tuple(p.shape) != (H,) for p in (bo, g1, be1, b2, g2,
                                                    be2))):
        raise ValueError(f"fused_layer_block: x must be [B, L, {H}], wo "
                         f"[{H}, {H}], w1 [F, {H}], w2 [{H}, F], b1 [F] and "
                         f"bo, g1, be1, b2, g2, be2 [{H}]")
    args = (q, k, v, bias, x, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2)
    dev = check_device(args, "fused_layer_block")
    if dev.type == "cpu":
        return fused_layer_block_plain(*args, eps)
    check_kernel_inputs("fused_layer_block", bf16=(q, k, v, x, wo, w1, w2),
                        fp32=(bias, bo, g1, be1, b1, b2, g2, be2))
    if d != HEAD_DIM or H != HIDDEN or Fi % FFN_CHUNK or not Fi:
        raise ValueError(f"fused_layer_block: the kernel takes head_dim "
                         f"{HEAD_DIM}, hidden {HIDDEN} and an intermediate "
                         f"width that is a positive multiple of {FFN_CHUNK}, "
                         f"got {d}, {H}, {Fi}")
    if not 1 <= L <= MAX_LEN:
        raise ValueError(f"fused_layer_block: the kernel takes joint lengths "
                         f"1..{MAX_LEN}, got {L}")
    if not all(t.is_contiguous() for t in (x, wo, w1, w2)):
        raise ValueError("fused_layer_block: x, wo, w1 and w2 must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (x, wo, w1, w2)):
        raise ValueError("fused_layer_block: x, wo, w1 and w2 must start on "
                         "a 16-byte boundary (the kernel reads them by TMA)")
    rs = heads_row_stride(q, k, v)
    out = torch.empty_like(x)
    build.launch("uc2_fused_layer_block", *(t.data_ptr() for t in args),
                 out.data_ptr(), B, L, n, rs, Fi, 1.0 / math.sqrt(d),
                 float(eps), device=dev)
    fused_layer_block.launches += 1
    return out


fused_layer_block.launches = 0


def fused_layer_profitable(L: int, n: int) -> bool:
    """Gate of the whole-layer fusion, copied from the reference package:
    always off (on the TPU the one kernel lost to the split #2 -> #3)."""
    return False


def fused_ffn_profitable(L: int) -> bool:
    """Gate of the FFN-block fusion, copied from the reference package:
    always on (it won at every retrieval bucket on the TPU)."""
    return True


def fused_block_profitable(L: int, n: int) -> bool:
    """Gate of the attention-block fusion, copied from the reference
    package: joint length L >= 128 (the TPU's in-graph verdict), or any L
    when the environment sets ``UC2_FUSE_ATTN_ALL`` (the reference's switch
    for in-graph A/Bs, read at every call)."""
    if os.environ.get("UC2_FUSE_ATTN_ALL"):
        return True
    return L >= 128
