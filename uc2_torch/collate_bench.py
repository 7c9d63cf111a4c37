"""Host batch-assembly throughput (port of the repository's
scripts/collate_bench.py): ``collate_batch`` examples/s at uc2-base field
sizes, nbb ~ U[10, 100], Lt ~ U[10, 62], fp16 or fp32 feature slabs, each
with and without MRFR's 2048-d slot targets. Host work only: no device.

    python -m uc2_torch.collate_bench [--batch 64] [--seconds 3]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from uc2_torch.data.collate import BucketSpec, collate_batch

CASES = ((False, False), (False, True), (True, False), (True, True))


def make_examples(rng, n, fp16, with_feat_targets):
    """``n`` examples drawn from ``rng`` (the reference script's draws)."""
    out = []
    dt = np.float16 if fp16 else np.float32
    for _ in range(n):
        L = int(rng.integers(10, 62))
        nbb = int(rng.integers(10, 100))
        tl = np.full(L, -1, np.int64)
        tl[rng.integers(0, L, 8)] = 5
        e = {"input_ids": rng.integers(2, 250000, L),
             "txt_labels": tl,
             "img_feat": rng.standard_normal((nbb, 2048)).astype(dt),
             "img_pos_feat": rng.random((nbb, 7)).astype(np.float32)}
        if with_feat_targets:
            e["img_masks"] = rng.random(nbb) < 0.15
            e["feat_targets"] = rng.standard_normal(
                (nbb, 2048)).astype(dt)
        out.append(e)
    return out


def main(argv=None):
    """Print one ``RESULT collate`` line a case; returns {(fp16,
    mrfr_targets): ex/s}."""
    ap = argparse.ArgumentParser(description="collate_batch throughput")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    spec = BucketSpec(64, 100, args.batch, 64)
    rates = {}
    for fp16, with_ft in CASES:
        exs = make_examples(rng, args.batch, fp16, with_ft)
        keys = ("feat_targets",) if with_ft else ()
        collate_batch(exs, spec, slot_target_keys=keys)   # warm
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < args.seconds:
            collate_batch(exs, spec, slot_target_keys=keys)
            n += args.batch
        rate = n / (time.perf_counter() - t0)
        rates[(fp16, with_ft)] = rate
        print(f"RESULT collate fp16={int(fp16)} "
              f"mrfr_targets={int(with_ft)}: {rate:.0f} ex/s", flush=True)
    return rates


if __name__ == "__main__":
    main()
