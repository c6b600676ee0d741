"""Run one cell of ``BENCHMARK.json`` on the card of this machine.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout.  The last line of standard
output is the result; the numbers compared with the reference, each with
its limit, are the last lines of standard error.  Exits non-zero, with no
result, where CUDA is missing or has fewer cards than the cell asks for.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root and the port's sources, never this folder itself
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from perfbench import harness

    chips = harness.load_cell(args.workload).spec["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t0=T0)
    return harness.report(result)


if __name__ == "__main__":
    sys.exit(main())
