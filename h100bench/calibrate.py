"""Readings that the check limits of ``workloads/<cell>.json`` are set
from: the check's numbers of the program over many seeds, and of the
control (the reference computed in fp8) and of the drivers' ``faults``
over a few, each seed a fresh set-up in this one process.

    python -m h100bench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --out file.jsonl [--seconds 0]

Each seed runs set-up, a window of ``--seconds`` (a scoring window makes
one call at 0, a training one needs a positive length) and the check; a
control seed also the control and the faults. One JSON line a seed. Not
part of a benchmark run.
"""

import argparse
import gc
import json
import os
import sys
import time

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", required=True, help="JSON lines, appended")
    args = p.parse_args(argv)
    from h100bench.harness import Bench, driver
    bench = Bench()
    w = bench.workload(args.workload)
    cfg, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        d = driver(traffic).Driver(cfg, traffic, seed, "cuda")
        d.setup()
        d.window(args.seconds)
        d.free()
        line = {"workload": args.workload, "seed": seed, "check": d.check()}
        if seed in ctl:
            line["control"] = d.control()
            line.update(d.faults())
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del d
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
