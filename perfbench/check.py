"""The comparison that decides ``correct``: the sampled answers of the
window, each held against the plain reference run on the same features,
weights and graph.

The number compared, ``logits_err``, is the worst over the sample of
``max |z - ref| / max |ref|`` over an answer's whole logits matrix.  An
answer that is not finite reads as infinitely wrong.  The control puts the
reference in TF32 (``reference.forward(..., tf32=True)``) in the program's
place.
"""
from __future__ import annotations

import math

import torch

from perfbench import reference


def gap(z: torch.Tensor, ref: torch.Tensor) -> float:
    """``max |z - ref| / max |ref|``; infinite where it is not finite."""
    e = float((z.float() - ref).abs().max() / ref.abs().max())
    return e if math.isfinite(e) else math.inf


def readings(cfg: dict, inputs, answers, control: bool = False) -> dict:
    """The numbers compared for ``answers`` (``(pool index, logits)``
    pairs; with ``control`` the logits are ignored and the TF32 reference
    stands in for them)."""
    adj = reference.Adjacency(inputs.n, inputs.src, inputs.dst)
    refs: dict[int, torch.Tensor] = {}
    ctrl: dict[int, torch.Tensor] = {}
    worst = math.inf if not answers else 0.0
    for k, z in answers:
        if k not in refs:
            refs[k] = reference.forward(cfg, adj, inputs.pool[k],
                                        inputs.params)
            if control:
                ctrl[k] = reference.forward(cfg, adj, inputs.pool[k],
                                            inputs.params, tf32=True)
        worst = max(worst, gap(ctrl[k] if control else z, refs[k]))
    return {"logits_err": worst}


def verdict(values: dict, limits: dict) -> dict:
    """``{name: {"value", "limit"}}`` for every limit of the cell; a number
    the run did not produce reads as infinite."""
    return {k: {"value": values.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
