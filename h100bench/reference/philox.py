"""Philox4x32-10 counter-based bits and the attention dropout mask drawn
from them, as the training attention kernels draw it.

Copied, frozen, from ``uc2_torch/ops/philox.py`` at commit 9035995 (the
whole-layer case, head offset 0). The mask of score (batch b, head h,
query i, key j) is word j % 4 of Philox4x32-10 of the counter
(j // 4, i, b * n + h, 0) under the key (seed, 0), kept where the word is
at least ``keep_threshold(rate)``. Words are held in int64; each 32 x 32
product is split at 16 bits so no partial product passes 2^63.
"""

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(m, x):
    a = x * (m >> 16)
    c = x * (m & 0xFFFF) + ((a & 0xFFFF) << 16)
    return (a >> 16) + (c >> 32), c & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    return min(int(rate * 4294967296.0), MASK32)


def keep_mask(seed: int, rate: float, B: int, n: int, L: int,
              device) -> torch.Tensor:
    """Bool [B, n, L, L]: True where the score is kept."""
    groups = (L + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    c0 = torch.arange(groups, **i64)
    c1 = torch.arange(L, **i64)[:, None]
    c2 = torch.arange(B * n, **i64)[:, None, None]
    zero = torch.zeros((), **i64)
    words = philox4x32(c0, c1, c2, zero, int(seed), 0)
    bits = torch.stack([w.expand(B * n, L, groups) for w in words], dim=-1)
    bits = bits.reshape(B, n, L, 4 * groups)[..., :L]
    return bits >= keep_threshold(rate)
