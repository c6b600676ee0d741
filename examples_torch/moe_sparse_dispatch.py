"""The paper's technique inside the LM stack, on the PyTorch port: MoE
expert dispatch as block-sparse matmul (the counterpart of
``examples/moe_sparse_dispatch.py``).

Top-6-of-64 routing means the token->expert activation matrix has 9.4%
density; the analyzer (TPU-v5e perf model) picks the sparse dispatch path,
and the block-sparse SpDMM kernel computes the same result as a dense
masked GEMM, shown numerically here.

    PYTHONPATH=src python examples_torch/moe_sparse_dispatch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.formats import pack_blockcsr
from repro_torch.models.ffn import moe_dispatch_report

# the demonstration's sparse == dense tolerance (the reference's)
ATOL = 1e-3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rep = moe_dispatch_report(ARCHS["deepseek-v2-lite-16b"], tokens=4096)
    print("analyzer decision for deepseek-v2-lite dispatch "
          f"(density {rep['density']:.3f}): {rep['primitive']}")
    print(f"  t_dense={rep['t_dense']:.3e}s  t_sparse={rep['t_sparse']:.3e}s")

    # numeric demo: block-sparse expert activation x dense weight
    rng = np.random.default_rng(0)
    T, E, B = 64, 8, 8          # tokens, experts, block
    mask = np.zeros((T // B, E), np.float32)
    for i in range(T // B):     # each token-block activates top-2 experts
        mask[i, rng.choice(E, 2, replace=False)] = 1.0
    acts = (rng.normal(size=(T, E * B)).astype(np.float32)
            * np.kron(mask, np.ones((B, B))))
    w = rng.normal(size=(E * B, 32)).astype(np.float32)

    a_sparse = pack_blockcsr(acts, B, device=dev)
    z_sparse = ops.spdmm(a_sparse, torch.as_tensor(w, device=dev))
    z_dense = acts @ w
    print(f"block density: {a_sparse.block_density():.3f} "
          f"(stored {a_sparse.nnzb}/{(T // B) * E} blocks)")
    print("sparse == dense:",
          bool(np.allclose(z_sparse.cpu().numpy(), z_dense, atol=ATOL)))


if __name__ == "__main__":
    main()
