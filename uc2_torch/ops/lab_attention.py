"""Attention with unnormalised bf16 probabilities, the kernel lab's
"v4bf16" candidate (port of scripts/kernel_lab.py ``_kernel_bf16``, kernel
#11: the streamed wgmma/TMA core of ``csrc/attention_stream.cuh`` in its
BF16P mode, entry ``csrc/attention_bf16.cu``).

It differs from the encoder's attention (#1, ``flash_attention_v3``),
which normalises the probabilities in fp32 and then rounds them: here
e = bf16(exp(s - max s)) is rounded unnormalised, summed in fp32 from the
rounded values, multiplied by bf16(v) with fp32 sums, and the product is
divided by the sum before the output is rounded to q's dtype. Nothing in
the encoder routes to it; ``uc2_torch.lab --mode op`` races it.

``attention_bf16_probs`` launches the kernel on CUDA tensors and counts the
launch in ``attention_bf16_probs.launches``; on CPU tensors it runs
``attention_bf16_probs_plain``.
"""

from __future__ import annotations

import math

import torch

from uc2_torch.ops import build
from uc2_torch.ops.flash_attention import (HEAD_DIM, MAX_LEN, check_device,
                                           check_heads, check_kernel_inputs,
                                           heads_row_stride)


def attention_bf16_probs_plain(q, k, v, bias):
    """#11's function in plain PyTorch: q, k, v [B, L, n, d]; bias
    [B, 1, 1, L] additive. Returns [B, L, n, d] in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blnd,bmnd->bnlm", q.float(), k.float())
    s = s * scale + bias.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True)).bfloat16().float()
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnlm,bmnd->bnld", e, v.bfloat16().float()) / denom
    return o.transpose(1, 2).to(q.dtype)


def attention_bf16_probs(q, k, v, bias):
    """Kernel #11 at any L up to 512: q, k, v [B, L, n, 64] bf16 (views
    into one QKV projection are taken as they are), bias [B, 1, 1, L]
    fp32. Returns [B, L, n, 64] bf16. Inference only: no backward."""
    check_heads(q, k, v, bias)
    dev = check_device((q, k, v, bias), "attention_bf16_probs")
    if dev.type == "cpu":
        return attention_bf16_probs_plain(q, k, v, bias)
    check_kernel_inputs("attention_bf16_probs", bf16=(q, k, v), fp32=(bias,))
    B, L, n, d = q.shape
    if d != HEAD_DIM or not 1 <= L <= MAX_LEN:
        raise ValueError(f"attention_bf16_probs: the kernel takes head_dim "
                         f"{HEAD_DIM} and joint lengths 1..{MAX_LEN}, got "
                         f"{d}, {L}")
    rs = heads_row_stride(q, k, v)
    out = torch.empty((B, L, n, d), dtype=q.dtype, device=dev)
    build.launch("uc2_attn_bf16_fwd", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(), B, L, n, rs,
                 1.0 / math.sqrt(d), device=dev)
    attention_bf16_probs.launches += 1
    return out


attention_bf16_probs.launches = 0
