"""Plain-torch oracles (dense float32 products) for the kernel tests."""
from __future__ import annotations

import torch

from repro_torch.kernels.formats import BlockCSR


def gemm_ref(x: torch.Tensor, y: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    return torch.matmul(x.float(), y.float()).to(out_dtype)


def spdmm_ref(a: BlockCSR, y: torch.Tensor,
              out_dtype=torch.float32) -> torch.Tensor:
    dense = a.todense().float()
    k = y.shape[0]
    return torch.matmul(dense[:, :k], y.float()).to(out_dtype)


def spmm_ref(a: BlockCSR, y: BlockCSR,
             out_dtype=torch.float32) -> torch.Tensor:
    return torch.matmul(a.todense().float(), y.todense().float()).to(out_dtype)
