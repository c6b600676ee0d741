"""Kernels of the port: BlockCSR packers, the fused Hopper kernels and their
plain PyTorch versions.

- ``gemm_batch_scatter`` — batched dense tile GEMM into a canvas (DTQ)
- ``spdmm_fused`` — block-sparse pool x dense, run per output block (STQ)
- ``spmm_fused`` — block-sparse x block-sparse pools (STQ)

CUDA sources live in ``csrc/`` and are built on first use by ``_build``;
``ops`` holds the public wrappers, ``ref`` the dense oracles.
"""
from repro_torch.kernels.formats import BlockCSR, pack_blockcsr, spmm_triples

__all__ = ["BlockCSR", "pack_blockcsr", "spmm_triples"]
