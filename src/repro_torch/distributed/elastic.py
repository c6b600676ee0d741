"""Elastic scaling: re-mesh and checkpoint reshard after node failures,
the reference's ``repro/distributed/elastic.py``.

Recovery path: a heartbeat monitor (``fault.py``) finds dead hosts; the
launcher computes the largest healthy mesh (the model axis kept intact,
data / pod shrunk, :func:`plan_remesh`); the latest checkpoint is
restored with the new mesh's specs (``CheckpointManager.restore(...,
shardings=...)`` inside ``with mesh:``); the train step is built for the
new mesh and training resumes.  The global batch stays the same: the
microbatches grow by ``microbatch_scale`` to cover the lost data-parallel
ranks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import Mesh, make_mesh_for_devices


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    n_devices: int
    mesh_shape: tuple
    microbatch_scale: int     # multiply cfg.microbatches by this


def plan_remesh(n_healthy: int, *, model_parallel: int = 16,
                original_data: int = 16, original_pods: int = 1) -> ElasticPlan:
    """Largest usable mesh after failures.

    Keeps the tensor-parallel degree (model-sharded weights can't reshard
    cheaply mid-run); shrinks data/pod to the largest power-of-two fit; the
    global batch is preserved by scaling microbatches.
    """
    if n_healthy < model_parallel:
        raise ValueError(
            f"{n_healthy} healthy chips < model_parallel={model_parallel}")
    data = n_healthy // model_parallel
    # largest power of two <= data (keeps batch divisibility)
    d = 1
    while d * 2 <= data:
        d *= 2
    orig = original_data * max(1, original_pods)
    assert orig % d == 0 or d % orig == 0
    scale = max(1, orig // d)
    return ElasticPlan(n_devices=d * model_parallel,
                       mesh_shape=(d, model_parallel),
                       microbatch_scale=scale)


def remesh(plan: ElasticPlan, device="cuda") -> Mesh:
    """The plan's ``("data", "model")`` mesh over the visible devices of
    ``device``'s type."""
    return make_mesh_for_devices(plan.n_devices,
                                 model_parallel=plan.mesh_shape[-1],
                                 device=device)
