"""The readings a cell's limits are set from, in one process on the card.

``python3 perfbench/limits.py --workload <name> --seeds 1,2,... --seconds 2
[--control 3]``

For each seed: the cell's inputs, its driver's set-up, a short window at
the cell's own load, the program freed, and the window's sampled answers
compared with the reference (the lower readings).  For the first
``--control`` seeds the control too: the reference in TF32 put in the
program's place on the same answers' features (the upper readings).  One
JSON line per seed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()

    import torch

    from perfbench import check, graphs, harness
    from perfbench.window import Sampler, sync

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    cell = harness.load_cell(args.workload)
    driver = harness.load_module(harness.PERF / "traffic"
                                 / f"{cell.mix['driver']}.py")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        inputs = graphs.make_inputs(cell.cfg, seed, cell.mix["pool"], dev)
        drv = driver.Driver(cell.cfg, cell.mix, inputs, dev, seed)
        sampler = Sampler(seed)
        win = drv.window(args.seconds, sampler)
        drv.close()
        del drv
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "completed": win.completed, "failed": win.failed,
                "kept": len(sampler.kept),
                **check.readings(cell.cfg, inputs, sampler.kept)}
        if i < args.control:
            ctrl = check.readings(cell.cfg, inputs, sampler.kept,
                                  control=True)
            line.update({f"control_{k}": v for k, v in ctrl.items()})
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del inputs, sampler
        sync(dev)
        torch.cuda.empty_cache()
    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: the process holds {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
