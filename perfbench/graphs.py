"""A cell's inputs, made on the device from ``--seed``.

- The graph: the Table IV stand-in of the port's ``data/graphs.py``,
  copied here as its generator does it (uniform sources, hub-skewed
  destinations ``floor(n * u**skew)``, self-loops added by the
  normalization), drawn from the seed on the device instead of numpy's
  stream on the host.
- A pool of feature matrices: one pattern at the table's density (exactly
  ``round(n * f * density)`` ones), each member with its own N(0, 0.01)
  noise on the non-zeros, as ``launch/gnn_serve.synthetic_requests`` makes
  its requests.
- Glorot-normal weights, one draw for all of them, from the
  configuration's own ``weights_seed``: the model is part of the
  configuration, as a trained checkpoint would be.  Drawn from the run's
  seed, the weights moved the hidden activations' density across the
  analyzer's threshold on some seeds and so changed the plan, and the work,
  from seed to seed.

Plain torch, no numpy on the large arrays: the whole set for FL takes a
fraction of a second on the card.  Nothing of the program is imported.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# one generator per kind of input, so adding pool members or weights never
# moves the graph a seed gives
STREAMS = {"graph": 1, "features": 2, "weights": 3}

# parameter shapes by model, in terms of (in, hidden, out)
PARAM_SHAPES = {
    "GCN": {"W1": ("in", "hidden"), "W2": ("hidden", "out")},
    "GIN": {"M1a": ("in", "hidden"), "M1b": ("hidden", "hidden"),
            "M2a": ("hidden", "hidden"), "M2b": ("hidden", "out")},
}


@dataclasses.dataclass
class Inputs:
    n: int                          # vertices
    src: torch.Tensor               # (edges,) int64, edge sources
    dst: torch.Tensor               # (edges,) int64, edge destinations
    pool: list[torch.Tensor]        # feature matrices, (n, features) float32
    params: dict[str, torch.Tensor]


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one input stream of ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * len(STREAMS) + STREAMS[stream]) % 2**63)
    return g


def sizes(graph: dict, scale: float = 1.0) -> tuple[int, int, int]:
    """(vertices, edges, features) of ``graph`` at ``scale``, shrunk as the
    port's ``load_graph(scale=...)`` shrinks them (for CPU rehearsals)."""
    n, e, f = graph["vertices"], graph["edges"], graph["features"]
    if scale == 1.0:
        return n, e, f
    return (max(64, int(n * scale)), max(128, int(e * scale)),
            max(16, int(f * min(1.0, scale * 4))))


def edges(n: int, e: int, skew: float, g: torch.Generator, device):
    """``e`` directed edges over ``n`` vertices: uniform sources,
    destinations ``min(floor(n * u**skew), n - 1)``."""
    src = torch.randint(0, n, (e,), generator=g, device=device)
    u = torch.rand(e, generator=g, device=device, dtype=torch.float64)
    dst = (n * u ** skew).long().clamp_(max=n - 1)
    return src, dst


def program_adjacency(n: int, src: torch.Tensor, dst: torch.Tensor):
    """The normalized adjacency ``D^-1/2 (A + I) D^-1/2`` (D the row
    degrees of A + I) as the program takes it: COO rows, cols (int32) and
    values (float32), sorted by row, duplicates kept."""
    loops = torch.arange(n, device=src.device)
    rows = torch.cat([src, loops])
    cols = torch.cat([dst, loops])
    deg = torch.bincount(rows, minlength=n).to(torch.float32)
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1.0))
    vals = dinv[rows] * dinv[cols]
    order = torch.sort(rows, stable=True).indices
    return (rows[order].to(torch.int32), cols[order].to(torch.int32),
            vals[order])


def feature_pool(n: int, f: int, density: float, size: int, noise: float,
                 g: torch.Generator, device) -> list[torch.Tensor]:
    """``size`` (n, f) matrices sharing one binary pattern of
    ``round(n * f * density)`` ones, each with N(0, ``noise``) added on the
    non-zeros."""
    nnz = max(1, round(n * f * density))
    base = torch.zeros(n * f, device=device)
    base[torch.randperm(n * f, generator=g, device=device)[:nnz]] = 1.0
    base = base.view(n, f)
    mask = base != 0
    return [base + noise * torch.randn(n, f, generator=g, device=device)
            * mask for _ in range(size)]


def glorot(model: str, dims: dict, g: torch.Generator,
           device) -> dict[str, torch.Tensor]:
    """Glorot-normal weights (std ``sqrt(2 / (fan_in + fan_out))``) of
    ``model``, drawn in one call and split in ``PARAM_SHAPES`` order."""
    shapes = {k: (dims[a], dims[b]) for k, (a, b)
              in PARAM_SHAPES[model].items()}
    flat = torch.randn(sum(m * k for m, k in shapes.values()), generator=g,
                       device=device)
    out, at = {}, 0
    for k, (m, k2) in shapes.items():
        std = math.sqrt(2.0 / (m + k2))
        out[k] = (flat[at:at + m * k2].view(m, k2) * std).contiguous()
        at += m * k2
    return out


def make_inputs(cfg: dict, seed: int, pool: int, device,
                scale: float = 1.0) -> Inputs:
    """Every input of a run of configuration ``cfg``: the graph and the
    feature pool from ``seed``, the weights from ``cfg["weights_seed"]``."""
    gr = cfg["graph"]
    n, e, f = sizes(gr, scale)
    src, dst = edges(n, e, gr["degree_skew"], generator(seed, "graph", device),
                     device)
    feats = feature_pool(n, f, gr["feature_density"], pool,
                         cfg["feature_noise"],
                         generator(seed, "features", device), device)
    params = glorot(cfg["model"],
                    {"in": f, "hidden": cfg["hidden"], "out": gr["classes"]},
                    generator(cfg["weights_seed"], "weights", device), device)
    return Inputs(n=n, src=src, dst=dst, pool=feats, params=params)
