"""The readings that set each cell's limits, on the card, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 [--sound S]

Without ``--sound`` it prints the control's readings: the reference in
bfloat16 (the precision below the configurations' float32) put in the
program's place and judged as a run judges the program. With ``--sound S``
it prints the program's readings instead: one run of the cell per seed, a
window of S seconds each, in this process, with ``--fault F`` the fault
``F`` of :mod:`benchmark.faults` planted. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sound", type=float, default=None)
    p.add_argument("--fault", default=None,
                   help="with --sound: a fault of benchmark.faults planted")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark import faults, guard, harness
    guard.check_start()
    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        if args.sound is not None:
            runs = []
            plant = contextlib.nullcontext() if args.fault is None else \
                getattr(faults, args.fault)()
            with plant:
                res = harness.run(cell, seed, args.sound, False,
                                  device=args.device, runs=runs)
            line = {"seed": seed, "side": args.fault or "program",
                    "correct": res["correct"], "attempted": res["attempted"],
                    "metrics": res["metrics"],
                    "checks": {k: c["value"]
                               for k, c in res["checks"].items()},
                    "counts": runs[0].counts}
        else:
            kind = cell.kind()
            if cell.traffic["kind"] == "render":
                gaps = kind.control_gaps(cell, seed, args.device,
                                         int(cell.workload["check"]
                                             ["renders"]))
                numbers = {"pixel_gap": max(gaps)}
            else:
                numbers = kind.control_readings(cell, seed, args.device)
            line = {"seed": seed, "side": "control", "checks": numbers}
        print(json.dumps(line), flush=True)
    guard.check_loaded()
    return 0


if __name__ == "__main__":
    sys.exit(main())
