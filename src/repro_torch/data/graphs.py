"""Graph datasets — synthetic stand-ins matching the paper's Table IV.

CiteSeer/Cora/PubMed/Flickr/NELL/Reddit are generated with the SAME vertex
count, edge count, feature dimension, class count, adjacency density and
input-feature density as Table IV, with a hub-skewed (Zipf-like) degree
distribution so per-stripe densities vary the way real scale-free graphs do.
The numpy RNG stream and the per-dataset crc32 seed are the reference's, so
the arrays match the reference package's byte for byte; only the final
containers are torch tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np
import torch

from repro_torch.core.primitives import SparseCOO
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetStats:
    name: str
    vertices: int
    edges: int
    features: int
    classes: int
    density_a: float          # Table IV "Density of A" (self-check only)
    density_h: float          # Table IV "Density of input H"
    hidden: int               # paper §IV-B: 16 for CO/CI/PU else 128


# Table IV, verbatim (Reddit edge count "11x10^7").
DATASETS: dict[str, DatasetStats] = {
    "CO": DatasetStats("CO", 2708, 5429, 2708, 7, 0.0014, 0.0127, 16),
    "CI": DatasetStats("CI", 3327, 4732, 3703, 6, 0.0008, 0.0085, 16),
    "PU": DatasetStats("PU", 19717, 44338, 500, 3, 0.0002, 0.10, 16),
    "FL": DatasetStats("FL", 89250, 899756, 500, 7, 0.0001, 0.46, 128),
    "NE": DatasetStats("NE", 65755, 251550, 61278, 186, 0.000058, 0.0001, 128),
    "RE": DatasetStats("RE", 232965, 110_000_000, 602, 41, 0.0021, 1.0, 128),
}


@dataclasses.dataclass
class Graph:
    stats: DatasetStats
    adj: SparseCOO            # row-normalized adjacency with self-loops
    features: torch.Tensor | SparseCOO   # dense H, or COO when ultra-sparse

    @property
    def features_dense(self) -> torch.Tensor:
        if isinstance(self.features, SparseCOO):
            return torch.as_tensor(self.features.todense(),
                                   device=self.features.device)
        return self.features

    @property
    def feature_density(self) -> float:
        if isinstance(self.features, SparseCOO):
            return self.features.density
        return float((self.features != 0).float().mean())


def _zipf_targets(rng: np.random.Generator, n: int, size: int,
                  skew: float = 2.0) -> np.ndarray:
    """Hub-skewed endpoint sampling: P(v) ∝ rank^-ish via u^skew mapping."""
    u = rng.uniform(size=size)
    return np.minimum((n * u ** skew).astype(np.int64), n - 1)


def _gen_edges(rng: np.random.Generator, n: int, e: int):
    src = rng.integers(0, n, size=e, dtype=np.int64)
    dst = _zipf_targets(rng, n, e)
    return src, dst


def _coo(shape, rows, cols, vals, tag, device) -> SparseCOO:
    return SparseCOO(
        shape,
        torch.as_tensor(rows.astype(np.int32), device=device),
        torch.as_tensor(cols.astype(np.int32), device=device),
        torch.as_tensor(vals.astype(np.float32), device=device),
        tag=tag)


def _normalize_adj(n: int, src: np.ndarray, dst: np.ndarray,
                   device) -> SparseCOO:
    """Â = D^{-1/2} (A + I) D^{-1/2} (GCN renormalization trick)."""
    rows = np.concatenate([src, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([dst, np.arange(n, dtype=np.int64)])
    deg = np.bincount(rows, minlength=n).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    vals = dinv[rows] * dinv[cols]
    order = np.argsort(rows, kind="stable")
    return _coo((n, n), rows[order], cols[order], vals[order], "adjacency",
                device)


def _gen_features(rng: np.random.Generator, stats: DatasetStats, device,
                  sparse_threshold: float = 0.01):
    """Bag-of-words-like binary features at the Table IV density.  Ultra-
    sparse feature matrices (NELL: 0.01%) stay in COO to avoid a 65k x 61k
    dense allocation."""
    n, f, d = stats.vertices, stats.features, stats.density_h
    if d >= 1.0:
        return torch.as_tensor(rng.normal(size=(n, f)).astype(np.float32),
                               device=device)
    nnz = max(1, int(round(n * f * d)))
    if d < sparse_threshold and n * f > 50_000_000:
        rows = rng.integers(0, n, size=nnz, dtype=np.int64)
        cols = rng.integers(0, f, size=nnz, dtype=np.int64)
        order = np.argsort(rows, kind="stable")
        return _coo((n, f), rows[order], cols[order],
                    np.ones(nnz, np.float32), "features", device)
    h = np.zeros((n, f), np.float32)
    idx = rng.choice(n * f, size=nnz, replace=False)
    h.flat[idx] = 1.0
    return torch.as_tensor(h, device=device)


@functools.lru_cache(maxsize=8)
def _load(name: str, scale: float, device: torch.device) -> Graph:
    stats = DATASETS[name]
    if scale != 1.0:
        stats = dataclasses.replace(
            stats,
            vertices=max(64, int(stats.vertices * scale)),
            edges=max(128, int(stats.edges * scale)),
            features=max(16, int(stats.features * min(1.0, scale * 4))),
        )
    # stable across processes (builtin hash() is salted)
    seed = zlib.crc32(f"{name}:{scale}".encode()) % (2**31)
    rng = np.random.default_rng(seed)
    src, dst = _gen_edges(rng, stats.vertices, stats.edges)
    adj = _normalize_adj(stats.vertices, src, dst, device)
    feats = _gen_features(rng, stats, device)
    return Graph(stats=stats, adj=adj, features=feats)


def load_graph(name: str, scale: float = 1.0, *, device="cuda") -> Graph:
    """Build the synthetic dataset on ``device``.  ``scale < 1`` shrinks
    vertices/edges proportionally (density preserved) for small runs.
    Cached per (name, scale, device)."""
    return _load(name, scale, resolve_device(device))
