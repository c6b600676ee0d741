"""End-to-end training demo on the PyTorch port: reduced phi3
config, checkpoint + restart mid-run (the fault-tolerance path), the loss
must improve (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples_torch/train_lm.py [--device cpu] [--ckpt-dir D]
"""
import argparse
import subprocess
import sys
import tempfile
from pathlib import Path


def main(argv=None) -> list[str]:
    """Runs both launches; returns their standard output lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_demo_ckpt"))
    args = ap.parse_args(argv)
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "phi3-mini-3.8b", "--ckpt-dir", args.ckpt_dir, "--batch", "8",
            "--seq", "64", "--device", args.device]
    lines = []
    for label, extra in (
            (">> train 12 steps (checkpoint every 6)",
             ["--steps", "12", "--ckpt-every", "6"]),
            (">> simulate preemption: resume from latest checkpoint, 6 more "
             "steps", ["--steps", "18", "--ckpt-every", "6", "--resume"])):
        print(label, flush=True)
        out = subprocess.run(base + extra, check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        lines += [label] + out.splitlines()
    return lines


if __name__ == "__main__":
    main()
