"""Roofline bounds of the port's kernels: the least time the card could
take for a launch, the larger of its bytes over the HBM bandwidth and its
matrix-product operations over the bf16 tensor rate.

Copied, frozen, from ``chip_smoke.py`` at commit 9035995 (``bound``, the
``run_case`` arguments of ``fused_ffn_block`` and ``time_fwd``, and
``time_passes``). Assumptions, as there: each input is read once and each
output written once, whatever the kernel reads again; 3.35 TB/s and 989
TFLOP/s (``frozen/flops.py``).
"""

from h100bench.frozen.flops import H100_BF16_FLOPS, H100_BYTES_PER_S


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work."""
    return max(nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS)


def ffn_block(rows: int, H: int = 768, FF: int = 3072):
    """#3 (``fused_ffn_block``): x read and y written in bf16, both weights
    in bf16, b1, b2, gamma and beta in fp32; the two products.
    Returns (bytes, flops)."""
    return (2 * rows * H * 2 + 2 * H * FF * 2 + (FF + 3 * H) * 4,
            4 * rows * H * FF)


def attn_train_fwd(b: int, L: int, N: int = 12, D: int = 64):
    """#5 (the training attention forward): q, k, v read and o written in
    bf16, the bias in fp32; Q.K^T and P.V."""
    H = N * D
    return 4 * b * L * H * 2 + b * L * 4, 4 * b * N * L * L * D


def _bwd_common(b, L, N, D, rate):
    H = N * D
    act, stat = b * L * H * 2, 3 * b * N * L * 4
    Lp = -(-L // 64) * 64
    bits = b * N * Lp * Lp // 8 if rate > 0.0 else 0
    return act, stat, bits


def attn_bwd_rows(b: int, L: int, N: int = 12, D: int = 64,
                  rate: float = 0.1):
    """#6a (backward pass 1): q, k, v, dO read and dQ written, the bias,
    the row statistics and the keep bits; its three products."""
    act, stat, bits = _bwd_common(b, L, N, D, rate)
    return 5 * act + b * L * 4 + stat + bits, 6 * b * N * L * L * D


def attn_bwd_keys(b: int, L: int, N: int = 12, D: int = 64,
                  rate: float = 0.1):
    """#6b (backward pass 2): q, k, v, dO read, dK and dV written, the
    bias, the statistics, the per-head dbias partials and the keep bits;
    its four products."""
    act, stat, bits = _bwd_common(b, L, N, D, rate)
    return (6 * act + b * L * 4 + stat + b * N * L * 4 + bits,
            8 * b * N * L * L * D)
