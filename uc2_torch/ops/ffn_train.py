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

Under tensor parallelism (``uc2_torch/parallel/tensor.py``) each process
holds F / T of the intermediate columns, and ``fused_ffn_block_train_partial``
runs #9 and #10 in their partial modes. Dropout is elementwise and linear,
and its mask is keyed on the global (row, column of H), which every shard
sees whole with the model group's one seed, so each shard masks its own
fp32 partial product (``keep ? (y [+ b2]) / (1 - rate) : 0``, b2 added by
one shard); the caller sums the partials over the group and adds the
residual and the LayerNorm in PyTorch. The backward takes the gradient of
that sum and returns the shard's part of dx (summed over the group by the
caller's ``copy_to_model``), its weight gradients, and db2 whole on every
process.
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


def _hidden(x, w1, b1):
    """On the [rows, H] view in the sum dtype: (x, a = x.W1^T + b1,
    h = gelu(a) rounded to x's dtype)."""
    ct = _sum_dtype(x)
    xr = x.reshape(-1, x.shape[-1]).to(ct)
    a = xr @ w1.to(ct).t() + b1.to(ct)
    return xr, a, F.gelu(a).to(x.dtype).to(ct)            # erf form


def _keep(seed, rate, rows, H, device):
    """The dropout's keep mask [rows, H], None at rate 0."""
    return ffn_keep_mask(seed, rate, rows, H, device) if rate > 0.0 else None


def _masked(y, keep, rate):
    """keep ? y / (1 - rate) : 0 (y itself without a mask)."""
    if keep is None:
        return y
    return torch.where(keep, y * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _forward_to_stats(x, w1, b1, w2, b2, seed, rate, eps):
    """The forward up to the LN statistics, in the sum dtype, on the [rows,
    H] view: (x, a, h, keep, yhat, inv), h rounded to x's dtype."""
    ct = _sum_dtype(x)
    xr, a, h = _hidden(x, w1, b1)
    keep = _keep(seed, rate, xr.shape[0], x.shape[-1], x.device)
    y = _masked(h @ w2.to(ct).t() + b2.to(ct), keep, rate) + xr
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


def _bwd_products(xr, a, h, w1, w2, dy2, dtype):
    """#10's products from the masked gradient dy2 of the second product's
    output, dy2 and da rounded to ``dtype`` first, as the reference rounds
    them: (da.W1, dW1, db1, dW2, db2) in the sum dtype."""
    ct = dy2.dtype
    db2 = dy2.sum(dim=0)
    dy2l = dy2.to(dtype).to(ct)
    dw2 = dy2l.t() @ h
    da = (dy2l @ w2.to(ct)) * _dgelu(a)
    db1 = da.sum(dim=0)
    dal = da.to(dtype).to(ct)
    return dal @ w1.to(ct), dal.t() @ xr, db1, dw2, db2


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
    dxa, dw1, db1, dw2, db2 = _bwd_products(
        xr, a, h, w1, w2, _masked(dy_pre, keep, rate), x.dtype)
    return ((dxa + dy_pre).to(x.dtype).reshape(x.shape), dw1, db1, dw2, db2,
            dgamma, dbeta)


def _check_shapes(what, x, w1, b1, w2, vecs):
    """w1 [F, H], w2 [H, F], b1 [F] and each of ``vecs`` (None: absent)
    [H], for x [..., H]."""
    H = x.shape[-1]
    Fi = w1.shape[0]
    if (tuple(w1.shape) != (Fi, H) or tuple(w2.shape) != (H, Fi)
            or tuple(b1.shape) != (Fi,)
            or any(tuple(p.shape) != (H,) for p in vecs if p is not None)):
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
    _check_shapes("fused_ffn_block_train_fwd", x, w1, b1, w2,
                  (b2, gamma, beta))
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
    _check_shapes("fused_ffn_block_train_bwd", x, w1, b1, w2, (b2, gamma))
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
        rows, Fi, BWD_SPLITS, 0), dtype=torch.uint8, device=dev)
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


def fused_ffn_block_train_partial_plain(x, w1, b1, w2, b2, seed: int,
                                        rate: float):
    """Kernel #9's partial mode in plain PyTorch: keep ? (bf16(gelu(x.W1^T
    + b1)).W2^T [+ b2]) / (1 - rate) : 0 in the sum dtype, [..., H]; b2 may
    be None."""
    xr, _, h = _hidden(x, w1, b1)
    y = h @ w2.to(h.dtype).t()
    if b2 is not None:
        y = y + b2.to(h.dtype)
    keep = _keep(seed, rate, xr.shape[0], x.shape[-1], x.device)
    return _masked(y, keep, rate).reshape(x.shape)


def fused_ffn_block_train_partial_bwd_plain(x, w1, b1, w2, seed: int,
                                            rate: float, dy):
    """Kernel #10's partial mode in plain PyTorch: for the gradient dy of
    the masked partial sum, (dx_part, dW1, db1, dW2, db2): dx_part = da.W1
    in x's dtype (without the residual's dy), the rest in the sum dtype,
    rounding where ``fused_ffn_block_train_bwd_plain`` rounds."""
    xr, a, h = _hidden(x, w1, b1)
    keep = _keep(seed, rate, xr.shape[0], x.shape[-1], x.device)
    dy2 = _masked(dy.reshape(xr.shape).to(xr.dtype), keep, rate)
    dxa, dw1, db1, dw2, db2 = _bwd_products(xr, a, h, w1, w2, dy2, x.dtype)
    return dxa.to(x.dtype).reshape(x.shape), dw1, db1, dw2, db2


def fused_ffn_block_train_partial_fwd(x, w1, b1, w2, b2, seed: int,
                                      rate: float):
    """Kernel #9's partial mode: x [..., H] (whole); w1 [F, H], b1 [F] and
    w2 [H, F] a shard of the intermediate ([out, in]); b2 [H] on one shard
    of the model group, None on the others; ``seed`` and ``rate`` the
    group's. Returns the fp32 masked partial [..., H]."""
    _check_shapes("fused_ffn_block_train_partial_fwd", x, w1, b1, w2, (b2,))
    vecs = (b1,) if b2 is None else (b1, b2)
    dev = check_device((x, w1, w2, *vecs),
                       "fused_ffn_block_train_partial_fwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        return fused_ffn_block_train_partial_plain(x, w1, b1, w2, b2, seed,
                                                   rate)
    _check_kernel("fused_ffn_block_train_partial_fwd", x, w1, w2, vecs)
    rows = x.numel() // x.shape[-1]
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if rows:
        build.launch("uc2_ffn_train_fwd_partial", x.data_ptr(),
                     w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     0 if b2 is None else b2.data_ptr(), out.data_ptr(),
                     rows, w1.shape[0], *_dropout_args(seed, rate),
                     device=dev)
        fused_ffn_block_train_partial_fwd.launches += 1
    return out


fused_ffn_block_train_partial_fwd.launches = 0


def fused_ffn_block_train_partial_bwd(x, w1, b1, w2, seed: int, rate: float,
                                      dy):
    """Kernel #10's partial mode: (dx_part, dW1, db1, dW2, db2) for dy
    [..., H], the fp32 gradient of the masked partial sum; dx_part = da.W1
    in x's dtype, the rest fp32, the weight gradients in ``nn.Linear``
    layout. The mask is redrawn from ``seed``."""
    _check_shapes("fused_ffn_block_train_partial_bwd", x, w1, b1, w2, ())
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    dev = check_device((x, w1, b1, w2, dy),
                       "fused_ffn_block_train_partial_bwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    if dev.type == "cpu":
        return fused_ffn_block_train_partial_bwd_plain(x, w1, b1, w2, seed,
                                                       rate, dy)
    _check_kernel("fused_ffn_block_train_partial_bwd", x, w1, w2, (b1, dy))
    if any(t.data_ptr() % 16 for t in (b1, dy)):
        raise ValueError("fused_ffn_block_train_partial_bwd: b1 and dy must "
                         "start on a 16-byte boundary (the kernel reads them "
                         "in 16-byte words)")
    H, Fi = x.shape[-1], w1.shape[0]
    rows = x.numel() // H
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty(Fi, H, **f32), torch.empty(H, Fi, **f32)
    db1, db2 = torch.empty(Fi, **f32), torch.empty(H, **f32)
    if not rows:
        return dx, dw1.zero_(), db1.zero_(), dw2.zero_(), db2.zero_()
    ws = torch.empty(build.load().uc2_ffn_train_bwd_workspace(
        rows, Fi, BWD_SPLITS, 1), dtype=torch.uint8, device=dev)
    build.launch("uc2_ffn_train_bwd_partial", x.data_ptr(), w1.data_ptr(),
                 b1.data_ptr(), w2.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(),
                 db2.data_ptr(), ws.data_ptr(), rows, Fi, BWD_SPLITS,
                 *_dropout_args(seed, rate), device=dev)
    fused_ffn_block_train_partial_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


fused_ffn_block_train_partial_bwd.launches = 0


class _FusedFfnTrainPartial(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seed, rate, add_b2):
        ctx.seed, ctx.rate = seed, rate
        ctx.save_for_backward(x, w1, b1, w2)
        return fused_ffn_block_train_partial_fwd(
            x, w1, b1, w2, b2 if add_b2 else None, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ffn_block_train_partial_bwd(
            x, w1, b1, w2, ctx.seed, ctx.rate, dy.contiguous())
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2, None, None, None)


def fused_ffn_block_train_partial(x, w1, b1, w2, b2, seed: int,
                                  rate: float, add_b2: bool):
    """The training FFN block's masked partial product on a shard of the
    intermediate (the module's docstring): x [..., H] (the whole block
    input, through ``copy_to_model``), w1 [F, H] and w2 [H, F] the
    shard's compute-dtype weights, b1 [F] and b2 [H] fp32, ``add_b2`` on
    one process of the model group. Forward and backward are kernels #9
    and #10 in their partial modes on CUDA tensors, their plain versions
    on CPU tensors. db2, the masked gradient summed over the rows, is
    returned on every process, b2 being replicated."""
    return _FusedFfnTrainPartial.apply(x, w1, b1, w2, b2, check_seed(seed),
                                       _check_rate(rate), bool(add_b2))
