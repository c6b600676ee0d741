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

:func:`compile_model` fuses a whole model's kernel sequence into one
program: on the card, one CUDA graph per input signature.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable

import numpy as np
import torch

from repro_torch.core import dispatch as _dispatch
from repro_torch.core import shard_exec as _shard_exec
from repro_torch.core import sparsity
from repro_torch.core.engine import DynasparseEngine, EngineReport
from repro_torch.core.primitives import SparseCOO
from repro_torch.device import as_tensor, capture_graph, resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.trace import span

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


@dataclasses.dataclass
class _Program:
    """One captured replay: the CUDA graph, its static input buffer and the
    static outputs the graph writes on every replay."""
    graph: "torch.cuda.CUDAGraph"
    h: torch.Tensor
    logits: torch.Tensor
    diags: list


@dataclasses.dataclass
class CompiledModel:
    """A whole model's kernel sequence as ONE program per input signature.

    After one eager warmup pass has planned, packed and lowered every
    kernel, a steady-state call is a single replay: no Python per-kernel
    dispatch, no descriptor work and no host read.  On a CUDA engine the
    program is a CUDA graph captured at the first call of each input
    signature ``(shape, dtype)`` (the reference's ``jax.jit(replay)``): the
    call copies ``h`` into the graph's static input buffer, replays the
    graph and returns a copy of its static output.  A capture that fails
    raises; nothing replays eagerly in its place.  On the CPU, which the
    caller names explicitly, each call runs the same Python body uncaptured.

    ``report`` is the warmup pass's :class:`EngineReport` (plan-time
    simulations, identical for every later call — :meth:`fresh_report`
    hands out copies).  Each call credits ``stats`` as the reference does:
    a trace build or hit, ``plan_hits`` for its sparse kernels and
    ``act_hits`` for its block-skip kernels.  ``capture_launches`` records,
    per signature, the kernel launches recorded while capturing: a replay
    runs no Python wrapper, so it is the count of launches per call.
    """
    model: str
    run: Callable                 # replay body: run(payload, h)
                                  #   -> (logits, activation diags)
    payload: list                 # per-kernel descriptor/pool tensors
    report: EngineReport          # warmup report template
    input_sketch: np.ndarray      # col-density sketch of the warmup features
    sketch_tile: int
    n_kernels: int
    n_sparse: int
    n_act: int = 0                # kernels on the capacity block-skip route
    # adjacency kernels on the in-place sparse body (dispatch.in_place)
    n_inplace: int = 0
    stats: object | None = None   # CacheStats receiving call accounting
    faults: object | None = None  # FaultInjector probed at "compiled"
    device: torch.device = torch.device("cpu")
    # a mesh engine's shard devices (empty for a single-device engine)
    mesh_devices: tuple = ()
    calls: int = 0
    traces: int = 0               # distinct input signatures (captures)
    # per-activation-kernel telemetry of the LAST call: stored / capacity /
    # logical block counts and the overflow flag (device scalars)
    last_activation: list = dataclasses.field(default_factory=list)
    capture_launches: dict = dataclasses.field(default_factory=dict)
    _programs: dict = dataclasses.field(default_factory=dict)

    def drifted(self, h, threshold: float, *, max_rows: int = 256,
                eps: float = 0.0) -> bool:
        """Has the input's column density drifted past ``threshold`` from
        the features this program was compiled against?  The program cannot
        sketch intermediate activations, so the input sketch is the
        invalidation signal: on drift the caller re-runs the eager path and
        recompiles."""
        sk = sparsity.sketch_col_density(as_tensor(h, self.device),
                                         self.sketch_tile,
                                         max_rows=max_rows, eps=eps)
        return sparsity.density_drift(sk, self.input_sketch) > threshold

    def fresh_report(self) -> EngineReport:
        return EngineReport(kernels=list(self.report.kernels),
                            meta=list(self.report.meta))

    def _capture(self, h: torch.Tensor) -> _Program:
        """Capture the replay body for ``h``'s signature
        (:func:`repro_torch.device.capture_graph`: one uncaptured run on a
        side stream, then the capture), counting the captured run's
        launches.  A mesh over several distinct cards is refused: a CUDA
        graph belongs to one device."""
        if len(set(self.mesh_devices)) > 1:
            raise NotImplementedError(
                "capturing a compiled model over a mesh of several cards "
                f"({[str(d) for d in self.mesh_devices]}) is not supported "
                "yet: a CUDA graph belongs to one device (ROADMAP, queue "
                "1); run the mesh engine eagerly instead")
        static_h = h.clone()
        launched = []

        def body():
            before = collections.Counter(_build.LAUNCHES)
            out = self.run(self.payload, static_h)
            launched.append(collections.Counter(_build.LAUNCHES) - before)
            return out
        graph, (logits, diags) = capture_graph(body, self.device)
        self.capture_launches[(tuple(h.shape), str(h.dtype))] = dict(
            launched[-1])
        return _Program(graph=graph, h=static_h, logits=logits, diags=diags)

    def __call__(self, h) -> torch.Tensor:
        with span("model.call"):
            return self._call(h)

    def _call(self, h) -> torch.Tensor:
        # the whole-model compiled-execute site, probed before any stats
        # are credited so a failed call never skews the hit accounting
        if self.faults is not None:
            self.faults.probe("compiled", detail=self.model)
        h = as_tensor(h, self.device)
        sig = (tuple(h.shape), str(h.dtype))
        new = sig not in self._programs
        if new:
            self._programs[sig] = (self._capture(h)
                                   if self.device.type == "cuda" else None)
        self.calls += 1
        self.traces += int(new)
        if self.stats is not None:
            if new:
                self.stats.trace_builds += 1
            else:
                self.stats.trace_cache_hits += 1
            self.stats.plan_hits += self.n_sparse
            self.stats.act_hits += self.n_act
        prog = self._programs[sig]
        if prog is None:
            with span("model.replay"):
                logits, self.last_activation = self.run(self.payload, h)
            return logits
        with span("model.copy_in"):
            prog.h.copy_(h)
        with span("model.replay"):
            prog.graph.replay()
        with span("model.copy_out"):
            self.last_activation = [
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in d.items()} for d in prog.diags]
            return prog.logits.clone()


def compile_model(model: str, engine: DynasparseEngine, adj, h, params,
                  *, transport=None, activation_skip: bool = True,
                  activation_slack: float = 1.5,
                  activation_per_stripe: bool = True):
    """Fuse all layer kernels of (model, graph, feature shape) into one
    program; returns ``(warmup logits, CompiledModel | None)``.

    The warmup is ONE ordinary eager pass through ``engine.matmul``: it
    plans, packs and lowers every adjacency kernel into the plan cache,
    while this function records each kernel's route.  The replay body then
    runs the model with every adjacency kernel as its compiled-dispatch
    body (:func:`~repro_torch.core.dispatch.apply_dispatch`; on a mesh
    engine the sharded body :func:`~repro_torch.core.shard_exec.
    apply_sharded`, halo exchange included, which a mesh whose shards all
    sit on one card captures into the same CUDA graph).

    Activation-side (dense X) kernels choose their route from the warmup
    plan: when its Analyzer routed tasks to the sparse engine, the kernel
    takes the capacity block-skip route
    (:func:`~repro_torch.core.dispatch.apply_activation_dispatch`, budget
    ``activation_slack`` × the warmup need, per stripe when
    ``activation_per_stripe``; a batch over budget takes the dense ``gemm``
    inside the same program).  Otherwise it stays one dense ``gemm``
    kernel.  ``activation_skip=False`` forces the dense route everywhere.

    ``None`` (second element) when any adjacency kernel has no compiled
    dispatch (non-literal or non-batched engines, canvas-misaligned
    geometry); the caller keeps the eager path.  ``transport`` optionally
    wraps the abstract ``mm`` (the serving layer's column-stacking) and
    must run only device operations.
    """
    transport = transport if transport is not None else (lambda mm: mm)
    h = as_tensor(h, engine.device)
    # ("sparse", geom) | ("shard", (geom, band_rows, halo)) | ("act", geom)
    # | ("gemm", None) per kernel
    records: list[tuple[str, object]] = []
    payload: list = []
    compilable = [True]
    n0 = len(engine.report.kernels)

    def recording(x, y, name="kernel"):
        z, _ = engine.matmul(x, y, name=name)
        if isinstance(x, SparseCOO):
            if engine.mesh is not None:
                spair = engine.sharded_operands(engine.last_plan, x)
                if spair is None:
                    compilable[0] = False
                    records.append(("gemm", None))
                    payload.append(None)
                else:
                    sd, xd = spair
                    records.append(("shard",
                                    (sd.geom, sd.band_rows, sd.halo)))
                    payload.append({"shards": sd.shards(engine.mesh.devices),
                                    "xd": xd})
                return z
            pair = engine.compiled_operands(engine.last_plan, x)
            if pair is None:
                compilable[0] = False
                records.append(("gemm", None))
                payload.append(None)
            else:
                d, xd = pair
                records.append(("sparse", d.geom))
                payload.append({"arrays": dict(d.arrays), "xd": xd,
                                "covered": d.covered})
        else:
            ad = (engine.activation_dispatch_for(
                      engine.last_plan, x, slack=activation_slack,
                      per_stripe=activation_per_stripe)
                  if activation_skip else None)
            if ad is None:
                records.append(("gemm", None))
                payload.append(None)
            else:
                records.append(("act", ad.geom))
                payload.append({"arrays": dict(ad.arrays)})
        return z

    logits = APPLY[model](transport(recording), adj, h, params)
    if not compilable[0]:
        return logits, None

    def replay(payload_, hh):
        ctr = itertools.count()
        act_diags = []

        def mm(x, y, name="kernel"):
            i = next(ctr)
            kind, geom = records[i]
            if kind == "gemm":
                return ops.gemm(x, y, out_dtype=torch.float32)
            p = payload_[i]
            if kind == "act":
                z, diag = _dispatch.apply_activation_dispatch(
                    geom, p["arrays"], x, y)
                act_diags.append(diag)
                return z
            if kind == "shard":
                sgeom, band_rows, halo = geom
                return _shard_exec.apply_sharded(
                    sgeom, band_rows, p["shards"], p["xd"], y,
                    devices=engine.mesh.devices, halo=halo)
            return _dispatch.apply_dispatch(geom, p["arrays"], p["xd"], y,
                                            covered=p["covered"])

        out = APPLY[model](transport(mm), adj, hh, params)
        return out, act_diags

    tn = engine.tile_n or min(128, int(h.shape[1]))
    sketch = sparsity.sketch_col_density(h, tn, max_rows=engine.sketch_rows,
                                         eps=engine.eps)
    report = EngineReport(kernels=list(engine.report.kernels[n0:]),
                          meta=list(engine.report.meta[n0:]))
    return logits, CompiledModel(
        model=model, run=replay, payload=payload, report=report,
        input_sketch=np.asarray(sketch), sketch_tile=tn,
        n_kernels=len(records),
        n_sparse=sum(1 for k, _ in records if k in ("sparse", "shard")),
        n_act=sum(1 for k, _ in records if k == "act"),
        n_inplace=sum(1 for k, g in records
                      if k == "sparse" and _dispatch.in_place(g)),
        stats=engine.cache.stats, faults=engine.faults,
        device=engine.device,
        mesh_devices=() if engine.mesh is None else engine.mesh.devices)


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
    if not isinstance(h, SparseCOO):
        h = as_tensor(h, dev)   # GIN adds h itself to its aggregation
    engine.reset()
    logits = APPLY[model](engine_mm(engine), adj, h, params)
    return logits, engine.report


def run_serving(model: str, engine: DynasparseEngine, adj, feature_batches,
                params, *, max_batch: int = 1, device="cuda"):
    """Serving path: repeated inference over a stream of feature matrices on
    a FIXED graph — a thin wrapper over :mod:`repro_torch.serving`.
    ``device`` must name the engine's device.

    Request 1 populates the engine's plan cache; every later request hits
    it, and the density sketch revalidates each hit against the live
    feature batch.  ``max_batch > 1`` coalesces the stream into
    micro-batches served with one plan/execute pass each.  Returns (list of
    logits, list of per-request engine reports — each the request's 1/k
    share of its micro-batch report)."""
    from repro_torch.serving import ServingConfig, ServingEngine

    dev = resolve_device(device)
    if dev != engine.device:
        raise ValueError(f"run_serving on {dev}, engine on {engine.device}")
    with ServingEngine(model, params, engine=engine,
                       config=ServingConfig(max_batch=max_batch)) as srv:
        srv.register_graph("default", adj)
        outs = srv.serve(("default", h) for h in feature_batches)
        by_id = sorted(srv.stats.requests, key=lambda r: r.request_id)
        return outs, [r.report for r in by_id]


def run_reference(model: str, adj, h, params):
    return APPLY[model](reference_mm, adj, h, params)
