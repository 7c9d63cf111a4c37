"""Run one cell of the benchmark once and print its result line.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared beside its
limit); the checks are also the last lines of standard error. Without
CUDA, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with 2, 2 or 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# a library the port uses must not load JAX or Flax by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from h100bench.harness import Bench, forbidden_modules, run_cell
    bench = Bench()
    chips = bench.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0=T0)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"h100bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("h100bench: loaded " + ", ".join(
        f"{m}={m in sys.modules}" for m in ("transformers",
                                            "torch.distributed.fsdp")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
