"""On-device density analysis (the measurement half of the paper's Analyzer).

Densities are cheap reductions on the operand's device; only the tiny
per-stripe density vectors travel to the host, once per kernel.

Dtypes and rounding follow the reference exactly, so a tie in the balanced
Analyzer resolves the same way in both packages.  Nonzero counts are
integers and every density is float32.  The reference divides the counts by
stripe sizes that are compile-time constants, and XLA rewrites a division
by a constant into a multiply by its float32 reciprocal; the port therefore
computes ``counts.float() * (1 / sizes)`` with the reciprocal rounded to
float32 on the host.  (A true division differs in the last bit for some
counts, e.g. 17 / 2368.)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import host


def _recip(sizes, device) -> torch.Tensor:
    """float32 reciprocal of host-side stripe sizes, as XLA folds it."""
    r = np.float32(1.0) / np.asarray(sizes, dtype=np.float32)
    return torch.as_tensor(r, device=device)


def density(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Fraction of nonzero elements (paper §II-B: density = nnz / size)."""
    nz = (x.abs() > eps).sum()
    return nz.float() * _recip(x.numel(), x.device)


def stripe_density(x: torch.Tensor, tile: int, axis: int = 0,
                   eps: float = 0.0) -> torch.Tensor:
    """Density of each row-stripe (axis=0) or col-stripe (axis=1), float32.

    Stripes are the task operands of Eq. 3: ``X_{i,:}`` / ``Y_{:,j}``.
    Ragged tails count only logical elements.  ``eps`` is the nonzero
    tolerance of :func:`density`."""
    m = x.shape[axis]
    n_stripes = -(-m // tile)
    pad = n_stripes * tile - m
    other = x.shape[1 - axis]
    if axis == 0:
        xp = F.pad(x, (0, 0, 0, pad)).reshape(n_stripes, tile, other)
        nz = (xp.abs() > eps).sum(dim=(1, 2))
    else:
        xp = F.pad(x, (0, pad)).reshape(other, n_stripes, tile)
        nz = (xp.abs() > eps).sum(dim=(0, 2))
    sizes = np.full(n_stripes, tile * other, dtype=np.int64)
    sizes[-1] = (m - (n_stripes - 1) * tile) * other
    return nz.float() * _recip(sizes, x.device)


def tile_density(x: torch.Tensor, tile_m: int, tile_n: int,
                 eps: float = 0.0) -> torch.Tensor:
    """(n_row_tiles, n_col_tiles) grid of per-tile densities, float32."""
    m, n = x.shape
    nrt, nct = -(-m // tile_m), -(-n // tile_n)
    xp = F.pad(x, (0, nct * tile_n - n, 0, nrt * tile_m - m))
    xp = xp.reshape(nrt, tile_m, nct, tile_n)
    nz = (xp.abs() > eps).sum(dim=(1, 3))
    return nz.float() * _recip(tile_m * tile_n, x.device)


def sketch_col_density(y: torch.Tensor, tile_n: int, *, max_rows: int = 256,
                       eps: float = 0.0) -> np.ndarray:
    """Cheap per-col-stripe density ESTIMATE from a strided row sample: at
    most ``max_rows`` evenly-strided rows, exact when ``K <= max_rows``."""
    K = y.shape[0]
    if K > max_rows:
        stride = -(-K // max_rows)
        y = y[::stride]
    return host(stripe_density(y, tile_n, axis=1, eps=eps))


def density_drift(sketch: np.ndarray, reference: np.ndarray) -> float:
    """Max per-stripe absolute density gap between a sketch and the densities
    a cached plan was built from.  Incomparable shapes count as infinite
    drift — always replan."""
    a = np.asarray(sketch, dtype=np.float64)
    b = np.asarray(reference, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)))


def block_density(x, block: int, eps: float = 0.0) -> float:
    """Fraction of non-zero B x B blocks — the block-skip α."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    t = host(tile_density(x, block, block, eps=eps))
    return float(np.mean(t > 0))
