"""PyTorch + CUDA port of the Versal-heterogeneity GNN inference runtime.

Same subpackage layout as the JAX reference package ``repro``: ``core/``
(planning, Analyzer, Scheduler, PlanCache, compiled dispatch, engine),
``kernels/`` (BlockCSR packers and the hand-written Hopper kernels with their
plain PyTorch versions), ``data/`` (Table IV stand-in graphs), ``models/``
(the GNN zoo and the LM stack's serving half), ``configs/`` (the LM
architectures), ``serving/``, ``distributed/`` and ``launch/``.  Entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""
