"""Attention kernels (port of uc2_tpu/ops/flash_attention.py).

* ``flash_attention``: the inference forward. It routes as the reference's
  ``_fwd_dispatch``: kernel #1 (``flash_attention_v3``, replacing
  ``_attn_kernel_v3``) while one batch row's fp32 [n, L, L] scores fit
  8 MiB, kernel #4 (``flash_attention_long``, replacing ``_attn_kernel``)
  above (``uses_long_kernel``: L >= 419 at 12 heads). The two TPU kernels
  compute one function and differ only in their batch blocking, so on the
  H100 both launch the streamed TMA/wgmma core of
  ``csrc/attention_stream.cuh`` through one C entry (``csrc/attention.cu``)
  and give the same bits; each counts its launches apart. Both backwards are
  the eager recompute through ``xla_attention``, as the reference's
  ``_fa_bwd``.
* ``flash_attention_train``: training attention with probs dropout inside
  the kernels, forward ``flash_attention_train_fwd`` (#5, the same core
  with Philox dropout) and backward ``flash_attention_train_bwd`` (#6,
  replacing ``_attn_train_bwd_kernel``; ``csrc/attention_train.cu``), both
  for joint lengths 1..512. The backward is two deterministic wgmma/TMA
  passes at every L: ``flash_attention_train_bwd_dq`` (rows: dQ, each
  row's softmax statistics and D, and the keep bits, the only Philox draw
  of the backward) and ``flash_attention_train_bwd_dkdv`` (keys: dK, dV and
  the per-head dbias partials from those statistics and bits). Neither
  uses atomics, so a step repeats bit for bit. The dropout mask is
  Philox4x32-10 keyed on (seed, global score index) (``ops/philox.py``):
  the backward draws the forward's mask. A launch over a tensor-parallel
  shard of the heads passes ``h0`` (its first head) and ``n_tot`` (the
  layer's head count), and draws the masks that those heads draw in the
  launch over all of them. What bounds each kernel on the H100 and how its
  design meets it is in the kernel's source.

Each kernel wrapper launches its CUDA kernel on CUDA tensors and counts
the launch in ``<wrapper>.launches`` (#1's in ``flash_attention.launches``;
#6 launches nothing of its own, and its two passes count in their
wrappers); on CPU tensors it runs the plain
PyTorch version beside it (``flash_attention_plain``,
``flash_attention_long_plain``, ``flash_attention_train_plain``,
``flash_attention_train_bwd_plain``, ``flash_attention_train_bwd_dq_plain``,
``flash_attention_train_bwd_dkdv_plain``). Any other input raises: there is
no fallback from a CUDA tensor to a plain version.
"""

from __future__ import annotations

import math

import torch

from uc2_torch.ops import build
from uc2_torch.ops.attention import xla_attention
from uc2_torch.ops.philox import (check_seed, head_index, keep_mask,
                                  keep_threshold)

HEAD_DIM = 64        # head width the kernels take
MAX_LEN = 512        # joint-length limit of the encoder
TILE = 64            # rows of the backward passes' tiles
LOG2E = 1.4426950408889634
LONG_KERNEL_BYTES = 8 * 1024 * 1024

flash_attention_plain = xla_attention


def uses_long_kernel(n: int, L: int) -> bool:
    """True where the reference's ``_fwd_dispatch`` takes ``_fwd_pallas``
    (#4) over the batch-blocked kernel: one batch row's fp32 scores,
    n * L * L * 4 bytes, above 8 MiB."""
    return n * L * L * 4 > LONG_KERNEL_BYTES


def flash_attention_long_plain(q, k, v, bias):
    """Kernel #4's function (the reference's ``_attn_kernel``) in plain
    PyTorch: fp32 scores * (1 / sqrt(d)) + bias, a max-shifted softmax
    normalised in fp32 and rounded to v's dtype, P.v with fp32 sums,
    returned in v's dtype."""
    p = _probs(q, k, bias)
    ct = p.dtype
    ctx = torch.einsum("bnlm,bmnd->blnd", p.to(v.dtype).to(ct), v.to(ct))
    return ctx.to(v.dtype)


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
    # one token a row: the token stride is the batch stride (any stride
    # of a size-1 dim is valid, so a view may report another)
    rs = q.stride(1) if L > 1 else q.stride(0) if B > 1 else n * d
    for t in (q, k, v):
        if (t.stride(3) != 1 or t.stride(2) != d
                or (L > 1 and t.stride(1) != rs)
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
def _stream_kernel(q, k, v, bias, what, counted):
    """#1 or #4 (``what``) on CUDA tensors: both launch the streamed core
    through one C entry; the launch counts in ``counted.launches``."""
    B, L, n, d = q.shape
    _check_len(what, d, L, MAX_LEN)
    rs = heads_row_stride(q, k, v)
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=q.device)
    build.launch("uc2_attn_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), device=q.device)
    counted.launches += 1
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
    """Kernel forward (#1 or #4, counted in ``counted``), eager-recompute
    backward (the reference's ``_fa_bwd``: the vjp of ``_xla_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, what, counted):
        ctx.save_for_backward(q, k, v, bias)
        return _stream_kernel(q, k, v, bias, what, counted)

    @staticmethod
    def backward(ctx, g):
        return (*_grads_of(xla_attention, ctx.saved_tensors,
                           ctx.needs_input_grad[:4], g), None, None)


def _inference(what, counted, plain, q, k, v, bias):
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), what)
    if dev.type == "cpu":
        return plain(q, k, v, bias)
    check_kernel_inputs(what, bf16=(q, k, v), fp32=(bias,),
                        has_backward=True)
    return _FlashAttention.apply(q, k, v, bias, what, counted)


def flash_attention_v3(q, k, v, bias):
    """Kernel #1, the batch-blocked forward, at any L up to 512: q, k, v
    [B, L, n, d]; bias [B, 1, 1, L] additive fp32. Returns
    softmax(q.k^T/sqrt(d) + bias).v as [B, L, n, d]."""
    return _inference("flash_attention_v3", flash_attention,
                      flash_attention_plain, q, k, v, bias)


def flash_attention_long(q, k, v, bias):
    """Kernel #4, the forward that streams K and V, at any L up to 512;
    arguments and result as ``flash_attention_v3``."""
    return _inference("flash_attention_long", flash_attention_long,
                      flash_attention_long_plain, q, k, v, bias)


def flash_attention(q, k, v, bias):
    """q, k, v [B, L, n, d]; bias [B, 1, 1, L] additive fp32.
    Returns softmax(q.k^T/sqrt(d) + bias).v as [B, L, n, d], from kernel #4
    where ``uses_long_kernel`` says so and from kernel #1 elsewhere."""
    check_heads(q, k, v, bias)
    if uses_long_kernel(q.shape[2], q.shape[1]):
        return flash_attention_long(q, k, v, bias)
    return flash_attention_v3(q, k, v, bias)


flash_attention.launches = 0        # kernel #1's launches
flash_attention_long.launches = 0


# -------------------------------------------------------------- training
def _sum_dtype(t):
    """fp32 for bf16/fp16/fp32 inputs; float64 stays float64 (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, bias):
    """q.k^T/sqrt(d) + bias in the sum dtype, [B, n, L, L]."""
    ct = _sum_dtype(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blnd,bmnd->bnlm", q.to(ct), k.to(ct))
    return s * scale + bias.to(ct)


def _probs(q, k, bias):
    """Max-shifted softmax of q.k^T/sqrt(d) + bias in the sum dtype,
    [B, n, L, L]."""
    return torch.softmax(_scores(q, k, bias), dim=-1)


def _keep(seed, rate, q, h0=0, n_tot=None):
    B, L, n, _ = q.shape
    return keep_mask(seed, rate, B, n, L, L, q.device, h0, n_tot)


def _heads(q, h0: int, n_tot):
    """(h0, n_tot) of a launch over q's heads, checked (None: all)."""
    n = q.shape[2]
    n_tot = n if n_tot is None else int(n_tot)
    head_index(1, n, int(h0), n_tot)
    return int(h0), n_tot


def _check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return rate


def _dprobs(g, v, keep, rate):
    """dP = keep ? (g.v^T)/(1 - rate) : 0 in the sum dtype, [B, n, L, L]."""
    ct = _sum_dtype(g)
    dp = torch.einsum("blnd,bmnd->bnlm", g.to(ct), v.to(ct))
    if keep is None:
        return dp
    return torch.where(keep, dp * (1.0 / (1.0 - rate)),
                       torch.zeros((), dtype=ct, device=dp.device))


def flash_attention_train_plain(q, k, v, bias, seed: int, rate: float,
                                h0: int = 0, n_tot=None):
    """The training forward in plain PyTorch: fp32 probabilities P, then
    Pd = keep ? P/(1 - rate) : 0 in fp32, rounded to v's dtype, then
    Pd.v with fp32 sums, returned in v's dtype. The heads are heads h0 ..
    of ``n_tot`` for the mask."""
    p = _probs(q, k, bias)
    if rate > 0.0:
        p = torch.where(_keep(seed, rate, q, h0, n_tot),
                        p * (1.0 / (1.0 - rate)),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    ct = p.dtype
    ctx = torch.einsum("bnlm,bmnd->blnd", p.to(v.dtype).to(ct), v.to(ct))
    return ctx.to(v.dtype)


def flash_attention_train_bwd_plain(q, k, v, bias, seed: int, rate: float,
                                    g, h0: int = 0, n_tot=None):
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
    keep = _keep(seed, rate, q, h0, n_tot) if rate > 0.0 else None
    pd = p if keep is None else torch.where(keep, p * (1.0 / (1.0 - rate)),
                                            zero)
    dv = torch.einsum("bnlm,blnd->bmnd", pd.to(g.dtype).to(ct), g.to(ct))
    dp = _dprobs(g, v, keep, rate)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsl = ds.to(q.dtype).to(ct)
    dq = torch.einsum("bnlm,bmnd->blnd", dsl, k.to(ct)) * scale
    dk = torch.einsum("bnlm,blnd->bmnd", dsl, q.to(ct)) * scale
    db = ds.sum(dim=(1, 2)).reshape(B, 1, 1, L)
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
            db.to(bias.dtype))


def padded_rows(L: int) -> int:
    """L rounded up to the backward passes' 64-row tiles."""
    return -(-L // TILE) * TILE


def _scores2(q, k, bias):
    """The backward passes' scores in base 2, [B, n, L, L] in the sum
    dtype: q.k^T * (scale * log2 e) + bias * log2 e."""
    ct = _sum_dtype(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blnd,bmnd->bnlm", q.to(ct), k.to(ct))
    return s * (scale * LOG2E) + bias.to(ct) * LOG2E


def pack_keep_bits(keep):
    """Bool [B, n, Lp, Lp] -> the passes' keep bits [B, n, Lp, Lp / 8]
    uint8: bit j % 8 of byte j // 8 of row i is set where score (i, j) is
    kept."""
    B, n, Lq, Lk = keep.shape
    w = keep.reshape(B, n, Lq, Lk // 8, 8).to(torch.int32)
    shift = torch.arange(8, dtype=torch.int32, device=keep.device)
    return (w << shift).sum(dim=-1).to(torch.uint8)


def unpack_keep_bits(bits, L: int):
    """The passes' keep bits -> bool [B, n, L, L]."""
    shift = torch.arange(8, dtype=torch.int32, device=bits.device)
    keep = (bits.to(torch.int32)[..., None] >> shift) & 1
    return keep.reshape(*bits.shape[:3], -1)[:, :, :L, :L].bool()


def flash_attention_train_bwd_dq_plain(q, k, v, bias, seed: int,
                                       rate: float, g, h0: int = 0,
                                       n_tot=None):
    """Pass 1 of #6 (rows) in plain PyTorch: (dq, stats, bits) in the
    kernel's layout. stats [3, B, n, L] in the sum dtype hold each query
    row's max of the base-2 scores s2 (``_scores2``), 1 / sum exp2(s2 -
    max) and D = sum dP * P; bits are the Philox keep mask of every score
    on the [Lp, Lp] grid of the passes' 64-row tiles (``pack_keep_bits``;
    None at rate 0); dq as in ``flash_attention_train_bwd_plain``."""
    B, L, n, _ = q.shape
    s = _scores2(q, k, bias)
    mx = s.amax(dim=-1)
    e = torch.exp2(s - mx[..., None])
    inv = 1.0 / e.sum(dim=-1)
    p = e * inv[..., None]
    keep = bits = None
    if rate > 0.0:
        Lp = padded_rows(L)
        keep = keep_mask(seed, rate, B, n, Lp, Lp, q.device, h0, n_tot)
        bits = pack_keep_bits(keep)
        keep = keep[:, :, :L, :L]
    dp = _dprobs(g, v, keep, rate)
    D = (dp * p).sum(dim=-1)
    ds = p * (dp - D[..., None])
    ct = p.dtype
    dq = torch.einsum("bnlm,bmnd->blnd", ds.to(q.dtype).to(ct),
                      k.to(ct)) / math.sqrt(q.shape[-1])
    return dq.to(q.dtype), torch.stack([mx, inv, D]), bits


def flash_attention_train_bwd_dkdv_plain(q, k, v, bias, seed: int,
                                         rate: float, g, stats, bits):
    """Pass 2 of #6 (keys) in plain PyTorch: (dk, dv, dbias_part) from pass
    1's statistics and keep bits (the mask is read from ``bits``, not
    redrawn; ``seed`` is not used), with P = exp2(s2 - max) * (1 / sum)
    and dbias_part [B, n, L] = dS summed over the queries (the wrapper of
    #6 sums it over heads)."""
    mx, inv, D = stats
    L = q.shape[1]
    p = torch.exp2(_scores2(q, k, bias) - mx[..., None]) * inv[..., None]
    ct = p.dtype
    zero = torch.zeros((), dtype=ct, device=p.device)
    keep = None if rate == 0.0 else unpack_keep_bits(bits, L)
    pd = p if keep is None else torch.where(keep, p * (1.0 / (1.0 - rate)),
                                            zero)
    dv = torch.einsum("bnlm,blnd->bmnd", pd.to(g.dtype).to(ct), g.to(ct))
    ds = p * (_dprobs(g, v, keep, rate) - D[..., None])
    dk = torch.einsum("bnlm,blnd->bmnd", ds.to(q.dtype).to(ct),
                      q.to(ct)) / math.sqrt(q.shape[-1])
    return dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=2).to(bias.dtype)


def _train_kernel_checks(what, q, k, v, bias):
    check_kernel_inputs(what, bf16=(q, k, v), fp32=(bias,),
                        has_backward=True)
    _check_len(what, q.shape[3], q.shape[1], MAX_LEN)
    return heads_row_stride(q, k, v)


def _drop_args(seed: int, rate: float):
    """The kernels' dropout arguments: seed, threshold, 1 / (1 - rate) and
    whether to drop at all."""
    return (seed, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0))


def flash_attention_train_fwd(q, k, v, bias, seed: int, rate: float,
                              h0: int = 0, n_tot=None):
    """Kernel #5: the training attention forward with probs dropout.
    q, k, v [B, L, n, d]; bias [B, 1, 1, L] fp32; ``seed`` a 32-bit int;
    ``rate`` in [0, 1); the heads are heads h0 .. h0 + n - 1 of ``n_tot``
    (None: n) for the mask. Returns [B, L, n, d] in v's dtype."""
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), "flash_attention_train_fwd")
    seed, rate = check_seed(seed), _check_rate(rate)
    h0, n_tot = _heads(q, h0, n_tot)
    if dev.type == "cpu":
        return flash_attention_train_plain(q, k, v, bias, seed, rate, h0,
                                           n_tot)
    rs = _train_kernel_checks("flash_attention_train_fwd", q, k, v, bias)
    B, L, n, d = q.shape
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    build.launch("uc2_attn_train_fwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), *_drop_args(seed, rate), h0, n_tot,
                 device=dev)
    flash_attention_train_fwd.launches += 1
    return out


flash_attention_train_fwd.launches = 0


def _bwd_checks(what, q, k, v, bias, g, seed, rate):
    check_heads(q, k, v, bias)
    if g.shape != q.shape:
        raise ValueError(f"g must be {tuple(q.shape)}, got {tuple(g.shape)}")
    dev = check_device((q, k, v, bias, g), what)
    return dev, check_seed(seed), _check_rate(rate)


def _pass_checks(what, q, k, v, bias, g):
    rs = _train_kernel_checks(what, q, k, v, bias)
    check_kernel_inputs(what, bf16=(g,), has_backward=True)
    return rs


def flash_attention_train_bwd_dq(q, k, v, bias, seed: int, rate: float, g,
                                 h0: int = 0, n_tot=None):
    """Pass 1 of #6 (rows): (dq, stats, bits) for the output gradient g, as
    ``flash_attention_train_bwd_dq_plain`` defines them: stats
    [3, B, n, L] fp32, bits [B, n, Lp, Lp / 8] uint8 (None at rate 0),
    the mask of heads h0 .. of ``n_tot`` as the forward's."""
    dev, seed, rate = _bwd_checks("flash_attention_train_bwd_dq", q, k, v,
                                  bias, g, seed, rate)
    h0, n_tot = _heads(q, h0, n_tot)
    if dev.type == "cpu":
        return flash_attention_train_bwd_dq_plain(q, k, v, bias, seed, rate,
                                                  g, h0, n_tot)
    rs = _pass_checks("flash_attention_train_bwd_dq", q, k, v, bias, g)
    B, L, n, d = q.shape
    g = g.contiguous()
    dq = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    stats = torch.empty((3, B, n, L), dtype=torch.float32, device=dev)
    Lp = padded_rows(L)
    bits = (torch.empty((B, n, Lp, Lp // 8), dtype=torch.uint8, device=dev)
            if rate > 0.0 else None)
    build.launch("uc2_attn_train_bwd_dq", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), g.data_ptr(), dq.data_ptr(),
                 stats.data_ptr(), 0 if bits is None else bits.data_ptr(),
                 B, L, n, rs, 1.0 / math.sqrt(d), *_drop_args(seed, rate),
                 h0, n_tot, device=dev)
    flash_attention_train_bwd_dq.launches += 1
    return dq, stats, bits


flash_attention_train_bwd_dq.launches = 0


def flash_attention_train_bwd_dkdv(q, k, v, bias, seed: int, rate: float, g,
                                   stats, bits, need_dbias: bool = True):
    """Pass 2 of #6 (keys): (dk, dv, dbias_part) from pass 1's ``stats``
    and ``bits`` (None at rate 0); dbias_part [B, n, L] fp32 (None unless
    ``need_dbias``) is dS summed over the queries of each head."""
    dev, seed, rate = _bwd_checks("flash_attention_train_bwd_dkdv", q, k, v,
                                  bias, g, seed, rate)
    B, L, n, d = q.shape
    if tuple(stats.shape) != (3, B, n, L) or stats.device != dev:
        raise ValueError(f"stats must be [3, B, n, L] = {(3, B, n, L)} on "
                         f"{dev}, got {tuple(stats.shape)} on {stats.device}")
    Lp = padded_rows(L)
    if rate > 0.0 and (bits is None or bits.dtype != torch.uint8
                       or tuple(bits.shape) != (B, n, Lp, Lp // 8)
                       or bits.device != dev):
        raise ValueError(f"at rate > 0, bits must be uint8 "
                         f"{(B, n, Lp, Lp // 8)} on {dev}, as pass 1 "
                         f"returns them")
    if dev.type == "cpu":
        dk, dv, dbp = flash_attention_train_bwd_dkdv_plain(
            q, k, v, bias, seed, rate, g, stats, bits)
        return dk, dv, (dbp if need_dbias else None)
    rs = _pass_checks("flash_attention_train_bwd_dkdv", q, k, v, bias, g)
    check_kernel_inputs("flash_attention_train_bwd_dkdv", fp32=(stats,),
                        has_backward=True)
    if bits is not None and (not bits.is_contiguous() or bits.data_ptr() % 8):
        raise ValueError("bits must be contiguous and 8-byte aligned")
    g = g.contiguous()
    dk, dv = (torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
              for _ in range(2))
    dbp = (torch.empty((B, n, L), dtype=torch.float32, device=dev)
           if need_dbias else None)
    build.launch("uc2_attn_train_bwd_dkdv", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                 stats.data_ptr(), 0 if rate == 0.0 else bits.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 0 if dbp is None else dbp.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), *_drop_args(seed, rate), device=dev)
    flash_attention_train_bwd_dkdv.launches += 1
    return dk, dv, dbp


flash_attention_train_bwd_dkdv.launches = 0


def flash_attention_train_bwd(q, k, v, bias, seed: int, rate: float, g,
                              need_dbias: bool = True, h0: int = 0,
                              n_tot=None):
    """Kernel #6: the training attention backward, (dq, dk, dv, dbias) for
    the output gradient g [B, L, n, d]; dbias is None unless
    ``need_dbias``. The mask (of heads h0 .. of ``n_tot``) is drawn from
    ``seed`` once, by pass 1. #6 is the two passes; each counts its launch
    in its own wrapper."""
    dev, seed, rate = _bwd_checks("flash_attention_train_bwd", q, k, v, bias,
                                  g, seed, rate)
    if dev.type == "cpu":
        dq, dk, dv, db = flash_attention_train_bwd_plain(q, k, v, bias, seed,
                                                         rate, g, h0, n_tot)
        return dq, dk, dv, (db if need_dbias else None)
    _pass_checks("flash_attention_train_bwd", q, k, v, bias, g)
    B, L = q.shape[:2]
    g = g.contiguous()
    dq, stats, bits = flash_attention_train_bwd_dq(q, k, v, bias, seed, rate,
                                                   g, h0, n_tot)
    dk, dv, dbp = flash_attention_train_bwd_dkdv(q, k, v, bias, seed, rate, g,
                                                 stats, bits, need_dbias)
    db = None if dbp is None else dbp.sum(dim=1).reshape(B, 1, 1, L)
    return dq, dk, dv, db


class _FlashAttentionTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, h0, n_tot):
        ctx.seed, ctx.rate, ctx.heads = seed, rate, (h0, n_tot)
        ctx.save_for_backward(q, k, v, bias)
        return flash_attention_train_fwd(q, k, v, bias, seed, rate, h0,
                                         n_tot)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = flash_attention_train_bwd(
            q, k, v, bias, ctx.seed, ctx.rate, g,
            ctx.needs_input_grad[3], *ctx.heads)
        return dq, dk, dv, db, None, None, None, None


def flash_attention_train(q, k, v, bias, seed: int, rate: float = 0.0,
                          h0: int = 0, n_tot=None):
    """Training attention: q, k, v [B, L, n, d], bias [B, 1, 1, L]
    additive fp32, ``seed`` a 32-bit int from which the dropout mask is
    drawn, ``rate`` the attention-probs dropout rate; the n heads are heads
    h0 .. h0 + n - 1 of ``n_tot`` (None: n) for the mask, so a shard of a
    layer's heads draws the masks of the whole layer's launch. Forward and
    backward are kernels #5 and #6 on CUDA tensors, their plain versions on
    CPU tensors; the backward returns dbias when the bias needs a
    gradient."""
    h0, n_tot = _heads(q, h0, n_tot)
    return _FlashAttentionTrain.apply(q, k, v, bias, check_seed(seed),
                                      _check_rate(rate), h0, n_tot)
