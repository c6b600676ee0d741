"""GNN model zoo of the paper: GCN, GraphSAGE(mean), GIN, SGC.

Every model is expressed against an abstract matmul ``mm(x, y, name)`` so the
same definition runs (a) through the DynasparseEngine, (b) as a plain dense
reference.  2-layer configurations per §IV-B: hidden 16 for CO/CI/PU, 128 for
FL/NE/RE.

Kernel ordering follows Dynasparse: aggregation ``Â·X`` and transformation
``X·W`` are separate kernels; for GCN/SGC/SAGE the FLOPs-optimal association
is used (transform-first when in_dim >= out_dim) — GIN's ``(1+ε)h + Â·h``
pins aggregation to the raw features.

Parameters are plain dicts of float32 tensors, initialized from the same
numpy stream as the reference (:func:`init_params`) or carried over from it
(:func:`params_from_jax`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import DynasparseEngine
from repro_torch.core.primitives import SparseCOO
from repro_torch.device import resolve_device

MM = Callable[..., torch.Tensor]   # mm(x, y, name=...) -> z

MODELS = ("GCN", "GraphSAGE", "GIN", "SGC")


def _glorot(rng: np.random.Generator, m: int, n: int) -> np.ndarray:
    s = np.sqrt(2.0 / (m + n))
    return rng.normal(0, s, size=(m, n)).astype(np.float32)


def init_params(model: str, in_dim: int, hidden: int, out_dim: int,
                seed: int = 0, *, device="cuda") -> dict[str, torch.Tensor]:
    """Glorot-normal weights from ``np.random.default_rng(seed)``, drawn in
    the reference's order, as float32 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if model == "GCN" or model == "SGC":
        shapes = {"W1": (in_dim, hidden), "W2": (hidden, out_dim)}
    elif model == "GraphSAGE":
        shapes = {"Ws1": (in_dim, hidden), "Wn1": (in_dim, hidden),
                  "Ws2": (hidden, out_dim), "Wn2": (hidden, out_dim)}
    elif model == "GIN":
        shapes = {"M1a": (in_dim, hidden), "M1b": (hidden, hidden),
                  "M2a": (hidden, hidden), "M2b": (hidden, out_dim)}
    else:
        raise ValueError(model)
    return {k: torch.as_tensor(_glorot(rng, *s), device=dev)
            for k, s in shapes.items()}


def params_from_jax(params: dict, device) -> dict[str, torch.Tensor]:
    """Carry the reference package's parameters (a dict of arrays, e.g. the
    numpy views of its ``init_params``) into the port's, on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=dev)
            for k, v in params.items()}


def _transform_then_aggregate(mm: MM, adj, h, w, tag: str):
    """Â·(h·W) vs (Â·h)·W by FLOPs; both orders routed through ``mm``."""
    in_dim, out_dim = w.shape
    if in_dim >= out_dim:
        z = mm(h, w, name=f"{tag}-update")
        return mm(adj, z, name=f"{tag}-agg")
    z = mm(adj, h, name=f"{tag}-agg")
    return mm(z, w, name=f"{tag}-update")


def gcn_apply(mm: MM, adj, h, p) -> torch.Tensor:
    z = torch.relu(_transform_then_aggregate(mm, adj, h, p["W1"], "l1"))
    return _transform_then_aggregate(mm, adj, z, p["W2"], "l2")


def sage_apply(mm: MM, adj, h, p) -> torch.Tensor:
    z_self = mm(h, p["Ws1"], name="l1-self")
    z_neigh = _transform_then_aggregate(mm, adj, h, p["Wn1"], "l1")
    z = torch.relu(z_self + z_neigh)
    z2 = mm(z, p["Ws2"], name="l2-self") + _transform_then_aggregate(
        mm, adj, z, p["Wn2"], "l2")
    return z2


def gin_apply(mm: MM, adj, h, p, eps: float = 0.0) -> torch.Tensor:
    # aggregation is pinned to raw features: (1+ε)h + Â·h
    def dense(x):
        if isinstance(x, SparseCOO):
            return torch.as_tensor(x.todense(), device=x.device)
        return x

    a1 = mm(adj, h, name="l1-agg")
    z = (1.0 + eps) * dense(h) + a1
    z = torch.relu(mm(z, p["M1a"], name="l1-mlp1"))
    z = torch.relu(mm(z, p["M1b"], name="l1-mlp2"))
    a2 = mm(adj, z, name="l2-agg")
    z = (1.0 + eps) * z + a2
    z = torch.relu(mm(z, p["M2a"], name="l2-mlp1"))
    return mm(z, p["M2b"], name="l2-mlp2")


def sgc_apply(mm: MM, adj, h, p) -> torch.Tensor:
    # SGC: Â^2 · X · W1 · W2, no nonlinearity — optimal order transforms first
    z = mm(h, p["W1"], name="update1")
    z = mm(z, p["W2"], name="update2")
    z = mm(adj, z, name="agg1")
    return mm(adj, z, name="agg2")


APPLY = {"GCN": gcn_apply, "GraphSAGE": sage_apply, "GIN": gin_apply,
         "SGC": sgc_apply}


# ---------------------------------------------------------------- runners
def engine_mm(engine: DynasparseEngine) -> MM:
    def mm(x, y, name="kernel"):
        z, _ = engine.matmul(x, y, name=name)
        return z
    return mm


def reference_mm(x, y, name="kernel"):
    """Dense float32 product of the densified operands (TF32 must be off
    on a card for this to be a float32 reference)."""
    dev = y.device if isinstance(y, torch.Tensor) else x.device
    if isinstance(x, SparseCOO):
        x = torch.as_tensor(x.todense(), device=dev)
    if isinstance(y, SparseCOO):
        y = torch.as_tensor(y.todense(), device=dev)
    return torch.matmul(x.float(), y.float())


def run_inference(model: str, engine: DynasparseEngine, adj, h, params, *,
                  device="cuda"):
    """Full-graph inference through the accelerator runtime; returns logits
    and the engine report accumulated across all kernels.  ``device`` must
    name the engine's device.

    ``engine.reset()`` clears only the report — the plan cache survives, so
    the adjacency's stripe densities, task assignment, packed BlockCSR
    stripes and compiled dispatches are built on the first call and reused
    by every layer and every later call on the same graph."""
    dev = resolve_device(device)
    if dev != engine.device:
        raise ValueError(f"run_inference on {dev}, engine on {engine.device}")
    engine.reset()
    logits = APPLY[model](engine_mm(engine), adj, h, params)
    return logits, engine.report


def run_reference(model: str, adj, h, params):
    return APPLY[model](reference_mm, adj, h, params)
