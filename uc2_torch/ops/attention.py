"""Multi-head attention of the UC2 encoder (port of uc2_tpu/ops/attention.py).

``xla_attention`` is the eager chain: scores/sqrt(d) + additive bias in
fp32 (``einsum_f32``: fp32 forward, compute-dtype backward), fp32 softmax,
optional probs dropout, probabilities cast to the value dtype, context in
the value dtype. ``multi_head_attention`` dispatches on the config's
``use_pallas_attention`` value exactly as the reference package does on a
TPU, with one difference: there is no device switch and no fallback. The
kernel paths go through ``ops/flash_attention`` and, for "flash",
``ops/segment_flash`` (``stock_flash_attention``), whose wrappers launch
the CUDA kernels on CUDA tensors (or raise) and take the plain versions
only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from uc2_torch.ops.mp import einsum_f32

_IMPLS = {False: "xla", True: "pallas"}


def resolve_impl(use_pallas) -> str:
    """Normalise a ``use_pallas_attention`` value to its string form."""
    impl = _IMPLS.get(use_pallas, use_pallas)
    if impl not in ("xla", "pallas", "pallas-train", "fused-force", "flash"):
        raise ValueError(f"unknown use_pallas_attention value {use_pallas!r}")
    return impl


def xla_attention(q, k, v, bias, dropout_rate: float = 0.0, rng=None,
                  heads=None):
    """q, k, v [B, L, n, d]; bias [B, 1, 1, L] additive. Returns
    [B, L, n, d] in v's dtype. Products and softmax run in fp32 on the
    (possibly bf16) inputs; with ``rng`` (a ``DropoutRng``) and a positive
    rate the probabilities are dropped with a mask drawn from
    ``rng.device``; they are rounded to v's dtype before P.V, as the
    reference's einsum chain does. ``heads`` = (h0, n_tot) says that the
    n heads are heads h0 .. h0 + n - 1 of n_tot (a tensor-parallel shard):
    the mask is then drawn for all n_tot heads and these heads' slice is
    kept, so the shard drops what the whole layer drops."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    scores = einsum_f32("blnd,bmnd->bnlm", q, k)
    scores = scores * scale + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        shape, h0 = probs.shape, 0
        if heads is not None:
            h0, n_tot = heads
            shape = (shape[0], n_tot, *shape[2:])
        keep = torch.rand(shape, generator=rng.device, device=probs.device
                          )[:, h0:h0 + probs.shape[1]] >= dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros((), device=probs.device))
    ctx = einsum_f32("bnlm,bmnd->blnd", probs.to(v.dtype), v)
    return ctx.to(v.dtype)


STOCK_FLASH_MIN_LEN = 128   # below, the reference's wrapper runs the eager chain


def stock_flash_attention(q, k, v, bias):
    """The counterpart of the reference's ``_stock_flash_attention``:
    ``xla_attention`` at L < 128, else the segment-masked library kernel's
    function (``ops/segment_flash.py``; kernels #12, #12a, #12b), which
    differs from ``xla_attention`` at invalid query rows."""
    if q.shape[1] < STOCK_FLASH_MIN_LEN:
        return xla_attention(q, k, v, bias)
    from uc2_torch.ops.segment_flash import segment_flash_attention
    return segment_flash_attention(q, k, v, bias)


def multi_head_attention(q, k, v, bias, dropout_rate: float = 0.0, rng=None,
                         use_pallas=False, heads=None):
    """Dispatch between attention backends, as uc2_tpu/ops/attention.py
    ``multi_head_attention`` routes on a TPU.

    ``rng`` (a ``DropoutRng``) is given on the training path when there is
    probs dropout or the impl is "pallas-train". Then "pallas" (rate > 0)
    and "pallas-train" (any rate) run ``flash_attention_train``, the
    training kernels, with a seed drawn from ``rng.host``. Otherwise a
    kernel impl at rate 0 runs ``flash_attention`` (the inference kernel,
    whose backward is the eager recompute), and everything else the eager
    ``xla_attention``. "flash" (the reference's wrapper of jax's library
    TPU kernel) runs ``stock_flash_attention`` at rate 0 (inference, and
    training at attention dropout 0) and the eager chain with dropout.
    ``heads`` = (h0, n_tot): q, k, v hold heads h0 .. of n_tot (a
    tensor-parallel shard), whose dropout masks are those heads' masks of
    the whole layer; None: all of them."""
    impl = resolve_impl(use_pallas)
    if impl != "xla":
        from uc2_torch.ops import flash_attention as fa
        if rng is not None and ((dropout_rate > 0.0 and impl in (
                "pallas", "pallas-train")) or impl == "pallas-train"):
            return fa.flash_attention_train(q, k, v, bias, rng.kernel_seed(),
                                            float(dropout_rate),
                                            *(heads or (0, None)))
        if dropout_rate == 0.0:
            if impl == "flash":
                return stock_flash_attention(q, k, v, bias)
            return fa.flash_attention(q, k, v, bias)
    return xla_attention(q, k, v, bias, dropout_rate, rng, heads)
