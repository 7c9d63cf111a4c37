"""Philox4x32-10 counter-based random bits, and the attention and FFN
dropout masks drawn from them (the plain version of ``csrc/philox.cuh``).

The training attention kernels (``csrc/attention_train.cu``) replace the
reference's per-grid-cell TPU PRNG stream
(uc2_tpu/ops/flash_attention.py ``_keep_mask``) with Philox keyed on the
seed and the global index of each score, so the forward and the backward
draw the same mask whatever tiles they use:

    key     = (seed, 0)
    counter = (j // 4, i, b * n_tot + h0 + h, 0)
    bits    = word j % 4 of Philox4x32-10(counter, key)

for score (batch b, head h, query i, key j) of a launch over the heads
h0 .. h0 + n - 1 of n_tot (h0 = 0, n_tot = n for a whole layer; a
tensor-parallel shard passes its offset and the layer's head count, so it
draws the masks of those heads of the whole), and a score is kept when
``bits >= keep_threshold(rate)``, as the reference compares its bits.

Torch has no unsigned 32-bit arithmetic, so the words are held in int64
and each 32 x 32 -> 64-bit product is split at 16 bits (every partial
product stays below 2^63); ``tests/test_torch_train.py`` holds the words
to Random123's published known answers.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # key increments (Weyl sequence)
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64
    tensor x of 32-bit values."""
    a = x * (m >> 16)                    # < 2^48
    c = x * (m & 0xFFFF) + ((a & 0xFFFF) << 16)   # < 2^49
    return (a >> 16) + (c >> 32), c & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words (int64 tensors holding 32-bit
    values, broadcast together) under the key (k0, k1); returns the four
    output words as int64 tensors."""
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Scores whose bits are >= this are kept (the reference's
    ``min(int(rate * 2^32), 2^32 - 1)``)."""
    return min(int(rate * 4294967296.0), MASK32)


def check_seed(seed) -> int:
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"dropout seed must fit 32 bits, got {seed}")
    return seed


def head_index(B: int, n: int, h0: int = 0, n_tot=None,
               device=None) -> torch.Tensor:
    """The masks' head index b * n_tot + h0 + h of each (b, h) of a launch
    over heads h0 .. h0 + n - 1 of ``n_tot`` (None: n), [B * n] int64."""
    n_tot = n if n_tot is None else int(n_tot)
    if not (0 <= h0 and h0 + n <= n_tot):
        raise ValueError(f"heads {h0} .. {h0 + n - 1} are not among "
                         f"{n_tot}")
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    h = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    return (b * n_tot + h0 + h).reshape(B * n)


def dropout_bits(seed: int, B: int, n: int, Lq: int, Lk: int,
                 device=None, h0: int = 0, n_tot=None) -> torch.Tensor:
    """The 32-bit words of every score, [B, n, Lq, Lk] int64 (heads h0 ..
    h0 + n - 1 of ``n_tot``)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    groups = (Lk + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=dev)
    c1 = torch.arange(Lq, dtype=torch.int64, device=dev)[:, None]
    c2 = head_index(B, n, h0, n_tot, dev)[:, None, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32(c0, c1, c2, zero, check_seed(seed), 0)
    bits = torch.stack([w.expand(B * n, Lq, groups) for w in words], dim=-1)
    return bits.reshape(B, n, Lq, 4 * groups)[..., :Lk]


def keep_mask(seed: int, rate: float, B: int, n: int, Lq: int, Lk: int,
              device=None, h0: int = 0, n_tot=None) -> torch.Tensor:
    """Bool [B, n, Lq, Lk]: True where the score is kept."""
    return (dropout_bits(seed, B, n, Lq, Lk, device, h0, n_tot)
            >= keep_threshold(rate))


def ffn_dropout_bits(seed: int, rows: int, H: int,
                     device=None) -> torch.Tensor:
    """The 32-bit words of the training FFN block's [rows, H] output:
    element (r, c) takes word c % 4 of Philox4x32-10 of the counter
    (c // 4, r, 0, 1) under the key (seed, 0). Counter word 3 = 1 keeps
    this stream apart from the attention scores'. [rows, H] int64."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    groups = (H + 3) // 4
    c0 = torch.arange(groups, dtype=torch.int64, device=dev)
    c1 = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32(c0, c1, zero, zero + 1, check_seed(seed), 0)
    bits = torch.stack([w.expand(rows, groups) for w in words], dim=-1)
    return bits.reshape(rows, 4 * groups)[:, :H]


def ffn_keep_mask(seed: int, rate: float, rows: int, H: int,
                  device=None) -> torch.Tensor:
    """Bool [rows, H]: True where the FFN block's output is kept."""
    return ffn_dropout_bits(seed, rows, H, device) >= keep_threshold(rate)
