"""Kernel lab of the port (port of scripts/kernel_lab.py): races the
hand-written kernels against the eager PyTorch chains they replace, at the
lab's shapes.

    python -m uc2_torch.lab [--mode op|block|block2|ffn|layer|ce]
        [--batch 64] [--txt_len 62] [--num_bb 100] [--iters 50]
        [--variants v3 v3bb1 v3bb4 v4bf16 v4qs xla sdpa] [--device cuda]

Each racer prints one line

    RESULT <name>: <ms> ms/<unit>  maxerr=<e>

with its time per call and its largest absolute difference from the
mode's reference racer. Times are CUDA events around ``--iters`` calls
after a warm-up; with ``--device cpu`` every kernel wrapper runs its plain
version and the times are the host's, a check of the control flow and no
measurement of a kernel. A racer that raises prints ``RESULT <name>:
FAILED ...`` (its traceback to stderr), the other racers still run, and
the lab exits 1. The modes, with their reference racer first:

  op      attention at [B, L, 12, 64] bf16 against the eager
          ``xla_attention``: v3, v3bb1, v3bb4, v4qs run #1
          (``flash_attention_v3``; the reference's batch-block and
          query-split variants of one function, whose tiles are TPU
          choices), v4bf16 runs #11 (``attention_bf16_probs``), sdpa is
          ``scaled_dot_product_attention`` as a yardstick;
  block   #2 (fusedblock) against the eager attention block (xlablock);
  block2  the QKV projection (cuBLAS) + #2 (v1chain) against #7 with the
          projection inside (v2inkernel);
  ffn     the eager FFN block (xlaffn) against #3 (fusedffn);
  layer   the eager layer (xlalayer) against #2 + #3 (split2) and #8
          (onekernel);
  ce      the LM head's CE gradient over x, the table and the bias at
          N = 24 B rows and V = 250002: eager logits and logsumexp
          (xlace_grad), the port's chunked CE (chunked8_grad), and the
          three N.V.H products alone (matmul_roofline, maxerr n/a), with
          TF/s of the three products.

The inputs are the reference lab's: numpy draws from seed 0 (weights drawn
in its [in, out] layout and handed over as nn.Linear's [out, in]), the
last 13 keys of every row masked.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

from uc2_torch import resolve_device
from uc2_torch.models.heads import (chunked_softmax_cross_entropy,
                                    cross_entropy_with_logits)
from uc2_torch.ops.attention import xla_attention
from uc2_torch.ops.flash_attention import flash_attention_v3
from uc2_torch.ops.fused_block import (fused_attn_block, fused_attn_block_v2,
                                       fused_ffn_block, fused_layer_block,
                                       layer_norm_f32)
from uc2_torch.ops.lab_attention import attention_bf16_probs
from uc2_torch.ops.mp import einsum_f32, mm_f32

N_HEADS, HEAD_DIM, HIDDEN, FFN = 12, 64, 768, 3072
VOCAB = 250002
CE_ROWS_PER_EXAMPLE = 24     # prediction slots per example (bench.py's M)
MASKED_KEYS = 13
MODES = ("op", "block", "block2", "ffn", "layer", "ce")


def time_ms(fn, iters: int = 20, warmup: int = 3, device=None) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``:
    CUDA events on a CUDA device (the default), the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    if device is not None and torch.device(device).type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class _Draw:
    """The reference lab's inputs: float64 normal draws from one seeded
    generator, in its order, moved to ``device``."""

    def __init__(self, device):
        self.rng = np.random.default_rng(0)
        self.device = device

    def _put(self, a, dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            self.device).to(dtype)

    def bf16(self, *shape, scale=1.0):
        return self._put(self.rng.standard_normal(shape) * scale,
                         torch.bfloat16)

    def f32(self, *shape, scale=1.0):
        return self._put(self.rng.standard_normal(shape) * scale,
                         torch.float32)

    def linear(self, n_in, n_out, scale):
        """A weight drawn as the reference's [in, out], as [out, in]."""
        return self.bf16(n_in, n_out, scale=scale).t().contiguous()

    def bias(self, B, L):
        mask = np.ones((B, L), np.float32)
        mask[:, -MASKED_KEYS:] = 0
        return self._put(((1.0 - mask) * -10000.0)[:, None, None, :],
                         torch.float32)

    def ln(self):
        """gamma = 1, beta = 0, as the reference lab's."""
        return (torch.ones(HIDDEN, device=self.device),
                torch.zeros(HIDDEN, device=self.device))


def _maxerr(out, want) -> str:
    """Largest absolute difference of a tensor, or of tuples of tensors."""
    if isinstance(out, torch.Tensor):
        out, want = (out,), (want,)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(out, want))
    return f"{err:.4e}"


def _race(racers, reference, unit, iters, device, notes=None,
          rate=None, uncompared=()):
    """Run each (name, fn) racer: its output against ``reference()``'s
    (maxerr n/a for the names in ``uncompared``), then its time; ``rate``
    maps the time to a note for every line. Returns the names of the
    racers that raised."""
    failed, want = [], None
    for name, fn in racers:
        note = f"  {notes[name]}" if notes and name in notes else ""
        try:
            out = fn()
            err = "n/a"
            if name not in uncompared:
                if want is None:
                    want = reference()
                err = _maxerr(out, want)
            del out
            ms = time_ms(fn, iters, device=device)
            if rate is not None:
                note += f"  [{rate(ms)}]"
            print(f"RESULT {name}: {ms:.4f} ms/{unit}  maxerr={err}{note}",
                  flush=True)
        except Exception as e:     # report the racer, run the others
            traceback.print_exc()
            print(f"RESULT {name}: FAILED {type(e).__name__} {str(e)[:200]}",
                  flush=True)
            failed.append(name)
    return failed


def sdpa(q, k, v, bias):
    """One ``scaled_dot_product_attention`` call on [B, L, n, d] heads: the
    library yardstick, never used by the port."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias.to(q.dtype)).transpose(1, 2)


OP_VARIANTS = {
    "v3": flash_attention_v3,
    "v3bb1": flash_attention_v3,
    "v3bb4": flash_attention_v3,
    "v4bf16": attention_bf16_probs,
    "v4qs": flash_attention_v3,
    "xla": xla_attention,
    "sdpa": sdpa,
}
OP_NOTES = {"v3": "(#1)", "v3bb1": "(#1)", "v3bb4": "(#1)", "v4qs": "(#1)",
            "v4bf16": "(#11)", "sdpa": "(library yardstick)"}


def op_race(B, L, iters, device, variants=tuple(OP_VARIANTS)):
    d = _Draw(device)
    q, k, v = (d.bf16(B, L, N_HEADS, HEAD_DIM) for _ in range(3))
    bias = d.bias(B, L)
    racers = [(name, lambda f=OP_VARIANTS[name]: f(q, k, v, bias))
              for name in variants]
    return _race(racers, lambda: xla_attention(q, k, v, bias), "op", iters,
                 device, OP_NOTES)


def eager_attn_block(q, k, v, bias, x, wo, bo, gamma, beta, eps=1e-12):
    """The reference lab's XLA attention block in eager PyTorch: the
    out-projection's product rounded to bf16, then + bo + x in fp32, LN."""
    B, L, n, d = q.shape
    ctx = xla_attention(q, k, v, bias).reshape(B, L, n * d).to(wo.dtype)
    y = (ctx @ wo.t()).float() + bo + x.float()
    return layer_norm_f32(y, gamma, beta, eps).to(x.dtype)


def eager_ffn_block(x, w1, b1, w2, b2, gamma, beta, eps=1e-12):
    """The reference lab's XLA FFN block in eager PyTorch: each product
    rounded to bf16, the erf GELU rounded to bf16, + x in fp32, LN."""
    h = F.gelu((x @ w1.t()).float() + b1).to(x.dtype)
    y = (h @ w2.t()).float() + b2 + x.float()
    return layer_norm_f32(y, gamma, beta, eps).to(x.dtype)


def block_race(B, L, iters, device):
    d = _Draw(device)
    q, k, v = (d.bf16(B, L, N_HEADS, HEAD_DIM) for _ in range(3))
    x = d.bf16(B, L, HIDDEN)
    wo, bo = d.linear(HIDDEN, HIDDEN, 0.02), d.f32(HIDDEN, scale=0.01)
    gamma, beta = d.ln()
    bias = d.bias(B, L)
    args = (q, k, v, bias, x, wo, bo, gamma, beta)
    racers = [("fusedblock", lambda: fused_attn_block(*args)),
              ("xlablock", lambda: eager_attn_block(*args))]
    return _race(racers, racers[1][1], "block", iters, device,
                 {"fusedblock": "(#2)"})


def block2_race(B, L, iters, device):
    d = _Draw(device)
    x = d.bf16(B, L, HIDDEN)
    w_qkv = d.linear(HIDDEN, 3 * HIDDEN, 0.02)
    b_qkv = d.f32(3 * HIDDEN, scale=0.01)
    wo, bo = d.linear(HIDDEN, HIDDEN, 0.02), d.f32(HIDDEN, scale=0.01)
    gamma, beta = d.ln()
    bias = d.bias(B, L)

    def v1chain():
        qkv = ((x @ w_qkv.t()).float() + b_qkv).to(x.dtype)
        q, k, v = (t.view(B, L, N_HEADS, HEAD_DIM)
                   for t in qkv.split(HIDDEN, dim=-1))
        return fused_attn_block(q, k, v, bias, x, wo, bo, gamma, beta)

    def v2inkernel():
        return fused_attn_block_v2(x, w_qkv, b_qkv, bias, wo, bo, gamma,
                                   beta, N_HEADS)

    return _race([("v1chain", v1chain), ("v2inkernel", v2inkernel)], v1chain,
                 "block", iters, device,
                 {"v1chain": "(cuBLAS QKV + #2)", "v2inkernel": "(#7)"})


def _ffn_weights(d):
    w1, b1 = d.linear(HIDDEN, FFN, 0.02), d.f32(FFN, scale=0.01)
    w2, b2 = d.linear(FFN, HIDDEN, 0.02), d.f32(HIDDEN, scale=0.01)
    return w1, b1, w2, b2


def ffn_race(B, L, iters, device):
    d = _Draw(device)
    x = d.bf16(B, L, HIDDEN)
    args = (x, *_ffn_weights(d), *d.ln())
    racers = [("xlaffn", lambda: eager_ffn_block(*args)),
              ("fusedffn", lambda: fused_ffn_block(*args))]
    return _race(racers, racers[0][1], "block", iters, device,
                 {"fusedffn": "(#3)"})


def layer_race(B, L, iters, device):
    d = _Draw(device)
    q, k, v = (d.bf16(B, L, N_HEADS, HEAD_DIM) for _ in range(3))
    x = d.bf16(B, L, HIDDEN)
    wo, bo = d.linear(HIDDEN, HIDDEN, 0.02), d.f32(HIDDEN, scale=0.01)
    g1, be1 = d.ln()
    w1, b1, w2, b2 = _ffn_weights(d)
    g2, be2 = d.ln()
    bias = d.bias(B, L)

    def xlalayer():
        x2 = eager_attn_block(q, k, v, bias, x, wo, bo, g1, be1)
        return eager_ffn_block(x2, w1, b1, w2, b2, g2, be2)

    def split2():
        x2 = fused_attn_block(q, k, v, bias, x, wo, bo, g1, be1)
        return fused_ffn_block(x2, w1, b1, w2, b2, g2, be2)

    def onekernel():
        return fused_layer_block(q, k, v, bias, x, wo, bo, g1, be1, w1, b1,
                                 w2, b2, g2, be2)

    return _race([("xlalayer", xlalayer), ("split2", split2),
                  ("onekernel", onekernel)], xlalayer, "layer", iters, device,
                 {"split2": "(#2 + #3)", "onekernel": "(#8)"})


def ce_race(B, iters, device, V=VOCAB):
    """The LM head's CE gradient at N = 24 B rows over a V-row table."""
    N, H = B * CE_ROWS_PER_EXAMPLE, HIDDEN
    d = _Draw(device)
    x = d.bf16(N, H, scale=0.05)
    table = d.bf16(V, H, scale=0.02)
    bias = torch.zeros(V, device=device)
    labels = torch.from_numpy(d.rng.integers(4, V, (N,))).to(device)
    w = torch.ones(N, device=device)

    def full_loss(x, table, bias):
        logits = einsum_f32("...h,vh->...v", x, table) + bias
        return cross_entropy_with_logits(logits, labels, w).sum()

    def chunked_loss(x, table, bias):
        return chunked_softmax_cross_entropy(x, table, bias, labels, w,
                                             n_chunks=8).sum()

    def grads(loss_fn):
        def run():
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, table, bias)]
            with torch.enable_grad():
                return torch.autograd.grad(loss_fn(*leaves), leaves)
        return run

    def matmul_roofline():
        """The three products a CE gradient must run, and nothing else."""
        g = (mm_f32(x, table.t()) * 1e-30 + 1.0).to(x.dtype)
        return mm_f32(g, table), mm_f32(g.t(), x)

    flops = 2 * N * V * H
    return _race([("xlace_grad", grads(full_loss)),
                  ("chunked8_grad", grads(chunked_loss)),
                  ("matmul_roofline", matmul_roofline)],
                 grads(full_loss), "grad", iters, device,
                 rate=lambda ms: f"{3 * flops / 1e12 / (ms / 1e3):.0f} TF/s "
                 f"of 3x{flops / 1e12:.2f} TF matmul work, N={N}, V={V}",
                 uncompared=("matmul_roofline",))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--txt_len", type=int, default=62)
    ap.add_argument("--num_bb", type=int, default=100)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--variants", nargs="*", default=list(OP_VARIANTS),
                    choices=list(OP_VARIANTS))
    ap.add_argument("--mode", choices=MODES, default="op")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, L = args.batch, args.txt_len + args.num_bb
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (plain versions; host times, not kernel times)")
    print(f"lab --mode {args.mode}: B={B} L={L} iters={args.iters} on "
          f"{where}", flush=True)
    if args.mode == "ce":
        failed = ce_race(B, args.iters, device)
    else:
        race = {"op": op_race, "block": block_race, "block2": block2_race,
                "ffn": ffn_race, "layer": layer_race}[args.mode]
        extra = {"variants": args.variants} if args.mode == "op" else {}
        with torch.no_grad():
            failed = race(B, L, args.iters, device, **extra)
    if failed:
        print(f"lab: {len(failed)} racer(s) failed: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
