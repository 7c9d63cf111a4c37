"""Training FFN block with output dropout (port of uc2_tpu/ops/ffn_train.py):

    LayerNorm(dropout(gelu(x.W1^T + b1).W2^T + b2) + x) * gamma + beta

``fused_ffn_block_train`` is an ``autograd.Function``: its forward is
kernel #9 (``fused_ffn_block_train_fwd``, ``csrc/fused_ffn_block.cu``: the
inference FFN block's kernel #3 with the dropout in its epilogue; at rate 0
it is #3's launch) and its
backward kernel #10 (``fused_ffn_block_train_bwd``, ``csrc/ffn_train_bwd.cu``:
a chain of wgmma/TMA products with fused epilogues, ``csrc/gemm.cuh``). The
backward recomputes the intermediates from x, as the reference's, and
returns dW1
and dW2 in the weights' dtype (the bf16 copies of the fp32 masters), the
vector gradients in fp32. The dropout mask is Philox4x32-10 keyed on
(seed, output row, output column) (``ops/philox.py`` ``ffn_keep_mask``), so
the backward redraws the forward's mask; it is not the reference's mask,
whose bits come from the TPU's PRNG per grid cell.

Each kernel wrapper launches its kernel on CUDA tensors and counts the
launch (``<wrapper>.launches``); on CPU tensors it runs the plain PyTorch
version beside it (``fused_ffn_block_train_plain``,
``fused_ffn_block_train_bwd_plain``). Anything else raises.

The encoder routes its training FFN here under ``pallas-train`` when the
environment sets ``UC2_FFN_TRAIN=1`` (``ffn_train_enabled``), the
reference's own switch, read at every forward.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from uc2_torch.ops import build
from uc2_torch.ops.flash_attention import (_check_rate, _sum_dtype,
                                           check_device, check_kernel_inputs)
from uc2_torch.ops.fused_block import HIDDEN
from uc2_torch.ops.philox import check_seed, ffn_keep_mask, keep_threshold

F_TILE = 128      # the kernels take intermediate widths that are multiples of this
BWD_SPLITS = 5    # most row splits of #10's weight-gradient products


def ffn_train_enabled() -> bool:
    """The reference's opt-in for the training FFN kernels
    (uc2_tpu/models/encoder.py reads it at trace time)."""
    return os.environ.get("UC2_FFN_TRAIN") == "1"


def _forward_to_stats(x, w1, b1, w2, b2, seed, rate, eps):
    """The forward up to the LN statistics, in the sum dtype, on the [rows,
    H] view: (x, a, h, keep, yhat, inv), h rounded to x's dtype."""
    ct = _sum_dtype(x)
    H = x.shape[-1]
    xr = x.reshape(-1, H).to(ct)
    a = xr @ w1.to(ct).t() + b1.to(ct)
    h = F.gelu(a).to(x.dtype).to(ct)                      # erf form
    y2 = h @ w2.to(ct).t() + b2.to(ct)
    keep = None
    if rate > 0.0:
        keep = ffn_keep_mask(seed, rate, xr.shape[0], H, x.device)
        y2 = torch.where(keep, y2 * (1.0 / (1.0 - rate)),
                         torch.zeros((), dtype=ct, device=x.device))
    y = y2 + xr
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return xr, a, h, keep, (y - mu) * inv, inv


def fused_ffn_block_train_plain(x, w1, b1, w2, b2, gamma, beta, seed: int,
                                rate: float, eps: float = 1e-12):
    """Kernel #9's function in plain PyTorch: fp32 sums, the GELU output
    rounded to x's dtype, the output in x's dtype."""
    *_, yhat, _ = _forward_to_stats(x, w1, b1, w2, b2, seed, rate, eps)
    ct = yhat.dtype
    out = yhat * gamma.to(ct) + beta.to(ct)
    return out.to(x.dtype).reshape(x.shape)


def _dgelu(a):
    """d/da [a Phi(a)] = Phi(a) + a phi(a)."""
    return (0.5 * (1.0 + torch.erf(a * (1.0 / math.sqrt(2.0))))
            + a * torch.exp(-0.5 * a * a) / math.sqrt(2.0 * math.pi))


def fused_ffn_block_train_bwd_plain(x, w1, b1, w2, b2, gamma, seed: int,
                                    rate: float, eps: float, dy):
    """Kernel #10's formulas (uc2_tpu/ops/ffn_train.py ``_bwd_kernel``) in
    plain PyTorch: returns (dx, dW1, db1, dW2, db2, dgamma, dbeta) for the
    output gradient dy, dx in x's dtype and the rest in the sum dtype,
    dW1 [F, H] and dW2 [H, F] in ``nn.Linear`` layout. dy2 and da are
    rounded to x's dtype before the products, as the reference rounds
    them."""
    xr, a, h, keep, yhat, inv = _forward_to_stats(x, w1, b1, w2, b2, seed,
                                                  rate, eps)
    ct = yhat.dtype
    dyr = dy.reshape(yhat.shape).to(ct)
    dgamma = (dyr * yhat).sum(dim=0)
    dbeta = dyr.sum(dim=0)
    dyn = dyr * gamma.to(ct)
    dy_pre = inv * (dyn - dyn.mean(dim=-1, keepdim=True)
                    - yhat * (dyn * yhat).mean(dim=-1, keepdim=True))
    dy2 = dy_pre
    if keep is not None:
        dy2 = torch.where(keep, dy_pre * (1.0 / (1.0 - rate)),
                          torch.zeros((), dtype=ct, device=x.device))
    db2 = dy2.sum(dim=0)
    dy2l = dy2.to(x.dtype).to(ct)
    dw2 = dy2l.t() @ h
    da = (dy2l @ w2.to(ct)) * _dgelu(a)
    db1 = da.sum(dim=0)
    dal = da.to(x.dtype).to(ct)
    dw1 = dal.t() @ xr
    dx = dal @ w1.to(ct) + dy_pre
    return (dx.to(x.dtype).reshape(x.shape), dw1, db1, dw2, db2, dgamma,
            dbeta)


def _check_shapes(what, x, w1, b1, w2, b2, vecs):
    H = x.shape[-1]
    Fi = w1.shape[0]
    if (tuple(w1.shape) != (Fi, H) or tuple(w2.shape) != (H, Fi)
            or tuple(b1.shape) != (Fi,)
            or any(tuple(p.shape) != (H,) for p in (b2, *vecs))):
        raise ValueError(f"{what}: w1 must be [F, {H}], w2 [{H}, F], b1 [F] "
                         f"and b2, gamma, beta [{H}]")


def _check_kernel(what, x, w1, w2, vecs):
    check_kernel_inputs(what, bf16=(x, w1, w2), fp32=vecs, has_backward=True)
    H, Fi = x.shape[-1], w1.shape[0]
    if H != HIDDEN or Fi % F_TILE:
        raise ValueError(f"{what}: the kernel takes hidden {HIDDEN} and an "
                         f"intermediate width that is a multiple of "
                         f"{F_TILE}, got {H}, {Fi}")
    if not (x.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError(f"{what}: x, w1 and w2 must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError(f"{what}: x, w1 and w2 must start on a 16-byte "
                         f"boundary (the kernel reads them by TMA)")


def _dropout_args(seed, rate):
    return (seed, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0))


def fused_ffn_block_train_fwd(x, w1, b1, w2, b2, gamma, beta, seed: int,
                              rate: float, eps: float = 1e-12):
    """Kernel #9. x [..., H]; w1 [F, H], w2 [H, F] ([out, in]); b1 [F];
    b2, gamma, beta [H]; ``seed`` a 32-bit int; ``rate`` in [0, 1).
    Returns [..., H] in x's dtype."""
    _check_shapes("fused_ffn_block_train_fwd", x, w1, b1, w2, b2,
                  (gamma, beta))
    dev = check_device((x, w1, b1, w2, b2, gamma, beta),
                       "fused_ffn_block_train_fwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        return fused_ffn_block_train_plain(x, w1, b1, w2, b2, gamma, beta,
                                           seed, rate, eps)
    _check_kernel("fused_ffn_block_train_fwd", x, w1, w2, (b1, b2, gamma, beta))
    rows = x.numel() // x.shape[-1]
    out = torch.empty_like(x)
    if rows:
        build.launch("uc2_ffn_train_fwd", x.data_ptr(), w1.data_ptr(),
                     b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                     gamma.data_ptr(), beta.data_ptr(), out.data_ptr(), rows,
                     w1.shape[0], float(eps), *_dropout_args(seed, rate),
                     device=dev)
        fused_ffn_block_train_fwd.launches += 1
    return out


fused_ffn_block_train_fwd.launches = 0


def fused_ffn_block_train_bwd(x, w1, b1, w2, b2, gamma, seed: int,
                              rate: float, eps: float, dy):
    """Kernel #10: (dx, dW1, db1, dW2, db2, dgamma, dbeta) for the output
    gradient dy; dx in x's dtype, the rest fp32, the weight gradients in
    ``nn.Linear`` layout. The mask is redrawn from ``seed``."""
    _check_shapes("fused_ffn_block_train_bwd", x, w1, b1, w2, b2, (gamma,))
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    dev = check_device((x, w1, b1, w2, b2, gamma, dy),
                       "fused_ffn_block_train_bwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        return fused_ffn_block_train_bwd_plain(x, w1, b1, w2, b2, gamma, seed,
                                               rate, eps, dy)
    _check_kernel("fused_ffn_block_train_bwd", x, w1, w2, (b1, b2, gamma))
    check_kernel_inputs("fused_ffn_block_train_bwd", bf16=(dy,),
                        has_backward=True)
    dy = dy.contiguous()
    if any(t.data_ptr() % 16 for t in (b1, b2, dy)):
        raise ValueError("fused_ffn_block_train_bwd: b1, b2 and dy must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "by TMA and in 16-byte words)")
    H, Fi = x.shape[-1], w1.shape[0]
    rows = x.numel() // H
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty(Fi, H, **f32), torch.empty(H, Fi, **f32)
    db1 = torch.empty(Fi, **f32)
    db2, dgamma, dbeta = (torch.empty(H, **f32) for _ in range(3))
    if not rows:
        return (dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_(),
                dgamma.zero_(), dbeta.zero_())
    ws = torch.empty(build.load().uc2_ffn_train_bwd_workspace(
        rows, Fi, BWD_SPLITS), dtype=torch.uint8, device=dev)
    build.launch("uc2_ffn_train_bwd", x.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                 db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                 ws.data_ptr(), rows, Fi, BWD_SPLITS, float(eps),
                 *_dropout_args(seed, rate), device=dev)
    fused_ffn_block_train_bwd.launches += 1
    return dx, dw1, db1, dw2, db2, dgamma, dbeta


fused_ffn_block_train_bwd.launches = 0


class _FusedFfnTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, gamma, beta, seed, rate, eps):
        ctx.seed, ctx.rate, ctx.eps = seed, rate, eps
        ctx.beta_dtype = beta.dtype
        ctx.save_for_backward(x, w1, b1, w2, b2, gamma)
        return fused_ffn_block_train_fwd(x, w1, b1, w2, b2, gamma, beta,
                                         seed, rate, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, gamma = ctx.saved_tensors
        dx, dw1, db1, dw2, db2, dg, dbeta = fused_ffn_block_train_bwd(
            x, w1, b1, w2, b2, gamma, ctx.seed, ctx.rate, ctx.eps, dy)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), dg.to(gamma.dtype), dbeta.to(ctx.beta_dtype),
                None, None, None)


def fused_ffn_block_train(x, w1, b1, w2, b2, gamma, beta, seed: int,
                          rate: float = 0.0, eps: float = 1e-12):
    """The training FFN block: x [..., H] (the attention block's LN
    output), w1 [F, H] and w2 [H, F] in ``nn.Linear`` layout (the compute
    dtype copies), b1, b2, gamma, beta fp32, ``seed`` a 32-bit int from
    which the output-dropout mask is drawn, ``rate`` its rate. Forward and
    backward are kernels #9 and #10 on CUDA tensors, their plain versions
    on CPU tensors."""
    return _FusedFfnTrain.apply(x, w1, b1, w2, b2, gamma, beta,
                                check_seed(seed), _check_rate(rate),
                                float(eps))
