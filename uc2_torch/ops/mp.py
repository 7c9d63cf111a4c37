"""Mixed-precision products: fp32 output forward, compute-dtype backward
(port of uc2_tpu/ops/mp.py ``einsum_f32``).

The forward sums bf16 operands in fp32 and returns fp32 (softmax scores,
LM logits). The backward casts the incoming fp32 gradient to the operands'
dtype before the transpose products, so they run bf16 x bf16 like every
other layer's backward instead of fp32 x fp32 over the 250k-row LM
decoder. In fp32 both directions equal a plain einsum.

On a CUDA tensor the fp32-output forward of the heads' decoder product
asks cuBLAS for fp32 output of the bf16 product directly
(``torch.mm(..., out_dtype=torch.float32)``; the port needs a PyTorch
that has it) instead of upcasting both operands to fp32: at uc2-base the LM head's
product takes 5.0 ms that way against 22.9 ms in fp32 on an H100
(PERF.md). Both give the fp32 sum of the same bf16 products.
"""

from __future__ import annotations

import torch


def mm_f32(a2, b2):
    """a2 [M, K] @ b2 [K, N] with fp32 output."""
    if a2.is_cuda and a2.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a2, b2, out_dtype=torch.float32)
    return torch.mm(a2.float(), b2.float())


def _forward(spec: str, a, b):
    if spec == "...h,vh->...v":          # x . W^T, the heads' decoders
        out = mm_f32(a.reshape(-1, a.shape[-1]), b.t())
        return out.reshape(*a.shape[:-1], b.shape[0])
    return torch.einsum(spec, a.float(), b.float())


class _EinsumF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spec, a, b):
        ctx.spec = spec
        ctx.save_for_backward(a, b)
        return _forward(spec, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        if ctx.spec == "...h,vh->...v":
            g2 = g.reshape(-1, b.shape[0])
            da = (g2 @ b).reshape(a.shape)
            return None, da, g2.t() @ a.reshape(-1, a.shape[-1])
        with torch.enable_grad():
            a_ = a.detach().requires_grad_(True)
            b_ = b.detach().requires_grad_(True)
            out = torch.einsum(ctx.spec, a_, b_)
            da, db = torch.autograd.grad(out, (a_, b_), g)
        return None, da, db


def einsum_f32(spec: str, a, b):
    """einsum with fp32 output whose backward runs in the operand dtype.
    ``a`` and ``b`` share one dtype."""
    if a.dtype != b.dtype:
        raise TypeError(f"einsum_f32: operands differ in dtype "
                        f"({a.dtype}, {b.dtype})")
    return _EinsumF32.apply(spec, a, b)
