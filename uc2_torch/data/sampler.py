"""Bucketed batch sampling (a copy of uc2_tpu/data/sampler.py).

Each example goes to the smallest ``BucketSpec`` that fits its (text
length, region count); each bucket has a fixed batch size chosen for a
roughly equal token budget, so every batch has one of a few shapes. The
epoch's order and its batch order are drawn from ``(seed, epoch)``, so one
seed gives the reference's schedule bit for bit.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from uc2_torch.data.collate import BucketSpec, pick_bucket


class BucketBatcher:
    """Yields (bucket_index, example_indices) batches.

    ``txt_lens`` / ``num_bbs``: each example's routing dims. Examples that
    fit no bucket are skipped (with one warning); with ``drop_last`` the
    incomplete batch of each bucket is dropped at the end of an epoch,
    else it is yielded as it is.
    """

    def __init__(self, txt_lens: Sequence[int], num_bbs: Sequence[int],
                 buckets: Sequence[BucketSpec], seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True):
        self.txt_lens = list(txt_lens)
        self.num_bbs = list(num_bbs)
        self.buckets = list(buckets)
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.routing = [pick_bucket(self.buckets, t, n)
                        for t, n in zip(self.txt_lens, self.num_bbs)]
        self.n_skipped = sum(r is None for r in self.routing)
        if self.n_skipped:
            skipped = [(t, n) for t, n, r in
                       zip(self.txt_lens, self.num_bbs, self.routing)
                       if r is None]
            logging.getLogger("uc2_torch").warning(
                "BucketBatcher: %d/%d examples fit no bucket and will be "
                "skipped every epoch (max txt_len=%d, max num_bb=%d; "
                "largest bucket=%s)", self.n_skipped, len(self.routing),
                max(t for t, _ in skipped), max(n for _, n in skipped),
                max(self.buckets, key=lambda b: (b.txt_len, b.num_bb)))

    def epoch(self, epoch: int) -> Iterator[Tuple[int, List[int]]]:
        rng = np.random.default_rng((self.seed, epoch))
        per_bucket: List[List[int]] = [[] for _ in self.buckets]
        order = np.arange(len(self.txt_lens))
        if self.shuffle:
            rng.shuffle(order)
        batches = []
        for i in order:
            b = self.routing[i]
            if b is None:
                continue
            per_bucket[b].append(int(i))
            if len(per_bucket[b]) == self.buckets[b].batch_size:
                batches.append((b, per_bucket[b]))
                per_bucket[b] = []
        for b, rest in enumerate(per_bucket):
            if rest and not self.drop_last:
                batches.append((b, rest))
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def batches_per_epoch(self) -> int:
        counts = [0] * len(self.buckets)
        for r in self.routing:
            if r is not None:
                counts[r] += 1
        total = sum(c // s.batch_size for c, s in zip(counts, self.buckets))
        if not self.drop_last:
            total += sum(1 for c, s in zip(counts, self.buckets)
                         if c % s.batch_size)
        return total
