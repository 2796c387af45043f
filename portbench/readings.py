"""Readings of the comparison's numbers over many seeds, in one process.

    python3 -m portbench.readings --workload CELL --seeds 1,2,3 --seconds S [--control]

Runs the cell once per seed (set-up, window, judgement: ``run.run_cell``)
and prints one JSON line per run with the numbers compared, the jobs'
outcomes and the metrics; ``--control`` runs the control instead: the
program with TF32 matmuls on, and the plain detector and the plain
refinement of points and cameras in bfloat16 in the place of the program's
detector and final bundle adjustment, judged by the same comparison. The
benchmark's own runs never run this; it gives the
lower and upper readings the limits in ``portbench/workloads/`` are set
from (``PERF.md`` lists them).
"""
from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                           tiny=args.tiny, control=args.control,
                           log=lambda m: print(m, file=sys.stderr, flush=True))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "metrics": res["metrics"],
                          "checks": {k: c["value"] for k, c in res["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
