"""Batched serving demo on the PyTorch port: greedy decode with a KV cache
on reduced configs, including the MoE arch whose expert dispatch routes
through the paper's analyzer (the counterpart of
``examples/serve_lm.py``).

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
"""
import argparse
import subprocess
import sys

ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-780m")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        print(f"== {arch} ==", flush=True)
        subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", arch, "--batch", "2", "--prompt-len", "8",
                        "--gen", "8", "--device", args.device], check=True)


if __name__ == "__main__":
    main()
