"""Functional compute primitives used by the engine.

The numerical result of a kernel is primitive-independent (GEMM, SpDMM and
SpMM all compute Z = X·Y); the primitive choice decides *time* and *data
movement*.  A non-literal engine therefore computes results through the
plainest equivalent path: a COO scatter-gather SpDMM (``index_add_``; the
adjacency is far too large to densify) and ``torch.matmul`` for dense
operands.  The literal engine runs the fused kernels instead.

``SparseCOO`` is the storage format of the paper's BufferA (Alg. 2).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import host


@dataclasses.dataclass
class SparseCOO:
    """COO sparse matrix over torch tensors (rows sorted; BufferA layout).

    ``rows``/``cols`` are int32 and ``vals`` float32, as in the reference,
    so their raw bytes fingerprint identically.  ``tag`` marks the matrix
    role ("adjacency" / "features" / "generic")."""
    shape: Tuple[int, int]
    rows: torch.Tensor   # (nnz,) int32
    cols: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor   # (nnz,) float
    tag: str = "generic"

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        return self.nnz / (self.shape[0] * self.shape[1])

    def todense(self) -> np.ndarray:
        """Dense host copy (``np.add.at`` sums duplicates in triplet order)."""
        vals = host(self.vals)
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (host(self.rows), host(self.cols)), vals)
        return out

    def row_stripe_density(self, tile_m: int, eps: float = 0.0) -> np.ndarray:
        """α(X_{i,:}) per row-stripe, float64 from nnz counts (host, O(nnz)).

        ``eps > 0`` drops stored values with ``|v| <= eps`` from the count;
        ``eps == 0`` counts every stored entry (nnz semantics)."""
        n_stripes = -(-self.shape[0] // tile_m)
        rows = host(self.rows)
        if eps > 0.0:
            rows = rows[np.abs(host(self.vals)) > eps]
        counts = np.bincount(rows // tile_m,
                             minlength=n_stripes).astype(np.float64)
        sizes = np.full(n_stripes, tile_m * self.shape[1], dtype=np.float64)
        tail = self.shape[0] - (n_stripes - 1) * tile_m
        sizes[-1] = tail * self.shape[1]
        return counts / sizes


def coo_spdmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              h: torch.Tensor, n_rows: int,
              chunk: int = 1_000_000) -> torch.Tensor:
    """Z = A @ H with A in COO — scatter-gather SpDMM (paper Alg. 2).

    Gather (Pairing Unit): ``h[cols]``; Update (Multiply Unit): ``vals * h``;
    Reduce (Accumulator): ``index_add_`` into output rows.  Chunked over
    edges so the gathered intermediate never exceeds ``chunk x d``, each
    chunk's segment sum added onto the running total as the reference's
    ``lax.scan`` does."""
    nnz = rows.shape[0]
    d = h.shape[1]

    def segment_sum(r, c, v):
        upd = v[:, None] * h[c.long()]
        return torch.zeros((n_rows, d), dtype=upd.dtype,
                           device=h.device).index_add_(0, r.long(), upd)

    if nnz <= chunk:
        return segment_sum(rows, cols, vals)
    acc = torch.zeros((n_rows, d), dtype=h.dtype, device=h.device)
    for s in range(0, nnz, chunk):
        acc = acc + segment_sum(rows[s:s + chunk], cols[s:s + chunk],
                                vals[s:s + chunk])
    return acc


def spdmm_exec(a: SparseCOO, h: torch.Tensor,
               chunk: int = 1_000_000) -> torch.Tensor:
    return coo_spdmm(a.rows, a.cols, a.vals, h, n_rows=a.shape[0],
                     chunk=chunk)


def gemm_exec(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), y.float())
