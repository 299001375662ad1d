"""Run one cell once on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``) runs from this module's start to the window's first
request, less what the traffic spends on the reference's work (a train
mix's target). A run that finds no card, or fewer cards than the cell
asks for, exits with 1 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from . import guard, harness
    guard.check_start()
    cell = harness.Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", t0=T0)
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
