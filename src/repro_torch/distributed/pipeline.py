"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis: the
reference's ``repro/distributed/pipeline.py`` with one controller.

Layers are split into S stages; M microbatches stream through them in the
classic fill-drain schedule, bubble fraction (S-1)/(M+S-1).  Stage ``s``'s
slice of the stacked stage parameters lives on the device of ``pipe``
coordinate ``s``; at tick ``t`` stage ``s`` runs microbatch ``t - s``, and
its output moves to the next stage's device (the reference's
``collective_permute``).  The controller runs the stages of a tick one
after another; on cards of their own their kernels overlap, as the
reference's SPMD stages do.  The reference's stages also run their body on
the empty slots of the fill and the drain and mask the result away; here
those slots are skipped.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.launch.mesh import Mesh


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stage_devices(mesh: Mesh) -> list[torch.device]:
    """The device of each ``pipe`` coordinate (every other axis at 0)."""
    at = [0] * len(mesh.axis_names)
    out = []
    for s in range(mesh.shape["pipe"]):
        at[mesh.axis_names.index("pipe")] = s
        out.append(mesh.device(at))
    return out


def pipeline_apply(
    mesh: Mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,        # tensors (or a dict / list of them) stacked
                              # on a leading axis of n_stages
    x: torch.Tensor,          # [M microbatches, mb, ...] inputs
) -> torch.Tensor:
    """Run ``x`` through the S stages of ``mesh``'s ``pipe`` axis; returns
    the outputs ``[M, mb, ...]`` on ``x``'s device."""
    devices = _stage_devices(mesh)
    n_stages, n_micro = len(devices), x.shape[0]
    params = [_tree_map(lambda a, s=s: a[s].to(devices[s]), stage_params)
              for s in range(n_stages)]
    inflight: dict[int, torch.Tensor] = {}      # stage -> its input
    outputs: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        arriving = {}
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            state = x[m].to(devices[0]) if s == 0 else inflight[s]
            y = stage_fn(params[s], state)
            if s == n_stages - 1:
                outputs[m] = y.to(x.device)
            else:
                arriving[s + 1] = y.to(devices[s + 1])
        inflight = arriving
    return torch.stack(outputs)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
