"""Activation-density sketch — drift revalidation config for serving.

A plan-cache hit reuses the STQ/DTQ assignment built from the FIRST
request's measured feature densities.  That is the intended amortization,
but it is a hazard when traffic drifts: a near-dense feature batch served
through an assignment measured on sparse features lands dense work on the
block-skip kernels, and vice versa.

The sketch is a strided row sample of the stacked micro-batch feature
matrix (``core.sparsity.sketch_col_density``), compared per col-stripe
against the plan's cached densities (``core.sparsity.density_drift``).
The engine consults it on every plan hit when ``drift_threshold`` is set;
:class:`SketchConfig` is how the serving layer sets it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sparsity import density_drift, sketch_col_density  # noqa: F401 (re-export)


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Revalidation policy applied to the engines a ServingEngine drives.

    ``threshold`` is the max tolerated per-stripe |density gap| before a
    cached plan is re-built (``None`` disables revalidation).  ``max_rows``
    bounds the sketch's row sample.
    """
    threshold: float | None = 0.25
    max_rows: int = 256

    def apply(self, engine) -> None:
        engine.drift_threshold = self.threshold
        engine.sketch_rows = self.max_rows
