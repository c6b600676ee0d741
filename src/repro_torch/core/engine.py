"""DynasparseEngine — the paper's accelerator runtime as a PyTorch module.

One engine instance owns: the hardware model (VCK5000 for paper-fidelity
decisions), the 2-D partitioning geometry, the Analyzer, the Scheduler, a
structure-keyed :class:`PlanCache` and the device it runs on.  Every GNN
kernel goes through::

    z, report = engine.matmul(x, y, name="agg-l1")

which splits into two phases:

- ``plan``: (1) measure stripe densities, (2) build the task grid, (3) run
  the Analyzer (STQ/DTQ assignment via the perf model), (4) simulate the
  Scheduler for the hardware-time estimate.  For a ``SparseCOO`` operand the
  whole phase is cached on the sparsity structure.

- ``execute``: compute the result — with the fused kernels when
  ``literal=True`` (one launch per primitive; adjacency kernels through a
  cached :class:`~repro_torch.core.dispatch.CompiledDispatch`, activation
  kernels through the eager batched drain; ``batched=False`` takes the
  per-task path, one kernel launch per task), or through the plainest
  equivalent path otherwise (COO ``index_add_`` and ``torch.matmul``).

:meth:`DynasparseEngine.activation_dispatch_for` lowers an activation
kernel into the capacity block-skip route that the whole-model compiler
(:func:`repro_torch.models.gnn.compile_model`) replays.

``calibration="auto"`` replaces a ``fallback=True`` model for analysis by
a measured :class:`~repro_torch.core.calibrate.CalibratedModel` of the
engine's device.  An optional fault injector (``faults=``) is probed at the
``plan``, ``pack`` and ``execute`` sites, at ``lower`` / ``pack`` of the
dispatch lowerings and, on mesh engines, at ``shard_lower`` /
``shard_exec``.

``mesh=`` (a :class:`~repro_torch.launch.mesh.DataMesh`) makes a mesh
engine: plans get a two-level (device, queue) placement
(``analyze_sharded``, over ``per_device_models`` when given) and literal
adjacency kernels run as a
:class:`~repro_torch.core.shard_exec.ShardedDispatch`, one banded program
per shard, with the dense operand distributed by ``operand_sharding``
(``"halo"``: owned rows plus a ring exchange; ``"replicate"``: whole).  A
mesh of size 1 takes the same sharded path.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import analyzer as _analyzer
from repro_torch.core import dispatch as _dispatch
from repro_torch.core import primitives as prim
from repro_torch.core import scheduler as _scheduler
from repro_torch.core import shard_exec as _shard_exec
from repro_torch.core import sparsity
from repro_torch.core.partition import choose_tile, make_tasks
from repro_torch.core.perfmodel import VCK5000, HardwareModel
from repro_torch.core.plancache import (KernelPlan, PlanCache, StructureEntry,
                                        coo_fingerprint)
from repro_torch.core.primitives import SparseCOO
from repro_torch.device import as_tensor, host, resolve_device
from repro_torch.kernels.formats import pack_blockcsr_coo

Mode = Literal["dynamic", "sparse_only", "dense_only"]


@dataclasses.dataclass
class EngineReport:
    """Accumulated per-kernel schedule reports (one inference run)."""
    kernels: list[tuple[str, _scheduler.ScheduleReport]] = dataclasses.field(
        default_factory=list)
    meta: list[dict] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> _scheduler.ScheduleReport:
        rep = _scheduler.ScheduleReport.zero()
        for _, r in self.kernels:
            rep = rep.merge(r)
        return rep

    @property
    def hardware_time(self) -> float:
        """End-to-end modelled hardware time: kernels are sequential across
        layers, each overlapping its two queues internally."""
        return sum(r.makespan for _, r in self.kernels)

    def attributed(self, k: int) -> "EngineReport":
        """An even per-request share of a micro-batch report: every kernel's
        cost fields divided by ``k`` (the batch's request count), so
        ``hardware_time`` and FLOPs sum back to the batch total across its
        requests.  The kernel list and task counts still describe the shared
        fused launches.  ``k <= 1`` returns ``self``."""
        if k <= 1:
            return self
        s = 1.0 / k
        return EngineReport(
            kernels=[(name, rep.scaled(s)) for name, rep in self.kernels],
            meta=list(self.meta))

    @property
    def by_device(self) -> list[_scheduler.ScheduleReport]:
        """Per-device totals of a (possibly) sharded run — one merged
        :class:`ScheduleReport` per mesh device.  Kernels without a
        per-device breakdown (unsharded plans) count for device 0, so an
        unsharded run returns ``[self.total]``."""
        out: list[_scheduler.ScheduleReport] = []
        for _, rep in self.kernels:
            per = list(rep.per_device) if rep.per_device else [rep]
            while len(out) < len(per):
                out.append(_scheduler.ScheduleReport.zero())
            for d, r in enumerate(per):
                out[d] = out[d].merge(r)
        return out


class DynasparseEngine:
    def __init__(
        self,
        hw: HardwareModel = VCK5000,
        *,
        tile_m: int | None = None,
        tile_n: int | None = None,
        mode: Mode = "dynamic",
        strategy: str = "balanced",
        literal: bool = False,
        block: int = 8,
        eps: float = 0.0,
        batched: bool = True,
        cache: PlanCache | None = None,
        drift_threshold: float | None = None,
        sketch_rows: int = 256,
        calibration: object = "auto",
        mesh: object = None,
        operand_sharding: str = "halo",
        per_device_models: "list[HardwareModel] | None" = None,
        faults: object = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        # a 1-D ("data",) DataMesh makes a mesh engine: sharded plan /
        # lower / execute, one banded program per shard; its device is the
        # mesh's first.  None = single-device engine (a size-1 mesh is the
        # degenerate case of the SAME sharded path).
        if mesh is not None:
            names = tuple(getattr(mesh, "axis_names", ()))
            if names != ("data",):
                raise ValueError(
                    f"DynasparseEngine mesh must be 1-D with axis ('data',), "
                    f"got axes {names!r}")
            kinds = {d.type for d in mesh.devices}
            if kinds != {self.device.type}:
                raise ValueError(
                    f"mesh devices {[str(d) for d in mesh.devices]} are not "
                    f"all of the engine's device type {self.device.type!r}")
            self.device = resolve_device(mesh.devices[0])
        self.mesh = mesh
        # dense-operand distribution of the sharded executor: "halo" ships
        # each shard its OWNED block-rows plus the halo its band reads;
        # "replicate" ships the whole operand (the bitwise oracle)
        if operand_sharding not in _shard_exec.OPERAND_SHARDINGS:
            raise ValueError(
                f"operand_sharding must be one of "
                f"{_shard_exec.OPERAND_SHARDINGS}, got {operand_sharding!r}")
        self.operand_sharding = operand_sharding
        # per-device cost models of the band placement (e.g. two card
        # generations) instead of n_devices copies of the runtime model
        if per_device_models is not None:
            if mesh is None:
                raise ValueError("per_device_models requires a mesh engine")
            if len(per_device_models) != mesh.size:
                raise ValueError(
                    f"per_device_models must list one model per mesh device "
                    f"({mesh.size}), got {len(per_device_models)}")
            per_device_models = list(per_device_models)
        self.per_device_models = per_device_models
        self.hw = hw
        # optional repro_torch.serving.faults.FaultInjector (anything with
        # .probe(site, detail)); None keeps every probe a no-op
        self.faults = faults
        self.calibration = calibration
        self._hw_runtime: HardwareModel | None = None
        self.tile_m = tile_m
        self.tile_n = tile_n
        self.mode = mode
        self.strategy = strategy
        self.literal = literal
        self.block = block
        self.eps = eps
        self.batched = batched
        self.cache = PlanCache() if cache is None else cache
        # density-drift revalidation of plan hits (None keeps the raw
        # first-call amortization)
        self.drift_threshold = drift_threshold
        self.sketch_rows = sketch_rows
        self.report = EngineReport()
        self.last_plan: KernelPlan | None = None

    @property
    def n_devices(self) -> int:
        """Mesh size (1 for single-device engines)."""
        return 1 if self.mesh is None else self.mesh.size

    def reset(self) -> None:
        """Clear the accumulated report.  The plan cache survives — it is
        keyed on operand structure, not on the inference run."""
        self.report = EngineReport()

    # ------------------------------------------------------------------
    def runtime_hw(self) -> HardwareModel:
        """The model the Analyzer/Scheduler consult, resolved once per
        engine: an explicit ``calibration`` model wins; ``"auto"``
        calibrates ``fallback=True`` models on the engine's device
        (cache-first: a warm ``PlanCache`` or ``$REPRO_CALIBRATION_PATH``
        snapshot means zero measurements) and leaves analytical models
        untouched; anything else keeps ``hw``."""
        if self._hw_runtime is None:
            hw = self.hw
            if isinstance(self.calibration, HardwareModel):
                hw = self.calibration
            elif self.calibration == "auto" and self.hw.fallback:
                from repro_torch.core import calibrate as _calibrate
                hw = _calibrate.get_calibrated(
                    self.cache, self.hw, block=self.block,
                    device=self.device)
            self._hw_runtime = hw
        return self._hw_runtime

    def _geometry(self, M: int, N: int) -> tuple[int, int]:
        tm, tn = self.tile_m, self.tile_n
        if tm is None or tn is None:
            ctm, ctn = choose_tile(M, N)
            tm = tm or ctm
            tn = tn or ctn
        return min(tm, M), min(tn, N)

    def _operand(self, x):
        if isinstance(x, SparseCOO):
            if x.device != self.device:
                raise ValueError(f"SparseCOO on {x.device}, engine on "
                                 f"{self.device}")
            return x
        return as_tensor(x, self.device)

    def plan(self, x, y, name: str = "kernel") -> KernelPlan:
        """Preprocessing phase: densities → task grid → Analyzer → simulated
        schedule.  Cached on the sparsity structure for ``SparseCOO`` x."""
        if self.faults is not None:
            self.faults.probe("plan", detail=name)
        x = self._operand(x)
        y = as_tensor(y, self.device)
        M, K = x.shape
        N = y.shape[1]
        if y.shape[0] != K:
            raise ValueError(
                f"engine.matmul inner-dim mismatch: x is ({M}, {K}), "
                f"y is {tuple(y.shape)}")
        tm, tn = self._geometry(M, N)

        hw = self.runtime_hw()
        struct_key = None
        plan_key = None
        if isinstance(x, SparseCOO):
            struct_key = (coo_fingerprint(x), tm, self.eps)
            plan_key = (struct_key, K, N, tn, self.mode, self.strategy,
                        hw.name)
            if self.mesh is not None:
                # the mesh geometry (and per-device model names, which move
                # the band DP) is part of a placed plan's identity
                mesh_key = ("mesh", self.n_devices)
                if self.per_device_models is not None:
                    mesh_key += tuple(m.name for m in self.per_device_models)
                plan_key = plan_key + (mesh_key,)
            cached = self.cache.get_plan(plan_key)
            if cached is not None:
                if self.drift_threshold is None:
                    self.last_plan = cached
                    return cached
                # revalidate the first-call Y-density assumption with a
                # cheap row-sampled sketch; replan on drift
                sk = sparsity.sketch_col_density(
                    y, tn, max_rows=self.sketch_rows, eps=self.eps)
                drift = sparsity.density_drift(sk, cached.col_density)
                if drift <= self.drift_threshold:
                    self.last_plan = cached
                    return cached
                self.cache.stats.plan_hits -= 1
                self.cache.stats.plan_misses += 1
                self.cache.stats.replans += 1

        # (1) dynamic density measurement (float64 for COO, float32 dense)
        if isinstance(x, SparseCOO):
            row_d = self.cache.row_density(
                struct_key,
                lambda: x.row_stripe_density(tm, eps=self.eps))
        else:
            row_d = host(sparsity.stripe_density(x, tm, axis=0, eps=self.eps))
        col_d = host(sparsity.stripe_density(y, tn, axis=1, eps=self.eps))

        # (2) task grid
        part = make_tasks(name, M, K, N, row_d, col_d, tm, tn)

        # (3) analyzer, (4) scheduler simulation → hardware-time estimate;
        # mesh engines also place contiguous stripe bands onto devices
        placement = None
        if self.mesh is not None:
            hws = (self.per_device_models
                   if self.per_device_models is not None
                   else [hw] * self.n_devices)
            stq, dtq, placement = _analyzer.analyze_sharded(
                part, hws, strategy=self.strategy, mode=self.mode)
            rep = _scheduler.simulate_sharded(stq, dtq, placement, hws)
        else:
            if self.mode == "dynamic":
                stq, dtq = _analyzer.analyze_kernel(part, hw, self.strategy)
            elif self.mode == "sparse_only":
                stq, dtq = _analyzer.force_queue(part, hw, "STQ")
            else:
                stq, dtq = _analyzer.force_queue(part, hw, "DTQ")
            rep = _scheduler.simulate(stq, dtq, hw)
        plan = KernelPlan(part=part, stq=stq, dtq=dtq, report=rep,
                          row_density=np.asarray(row_d),
                          col_density=np.asarray(col_d),
                          struct_key=struct_key, placement=placement)
        if plan_key is not None:
            self.cache.put_plan(plan_key, plan)
        self.last_plan = plan
        return plan

    def _packed_structure(
            self, plan: KernelPlan,
            x: SparseCOO) -> tuple[tuple, StructureEntry]:
        """Packed BlockCSR row-stripes, cached per structure (one packing
        serves every kernel width and every request).  Stripes are packed on
        the host straight from the COO triplets — no dense intermediate —
        and uploaded to the engine's device."""
        tm = plan.part.tile_m
        nrt = plan.part.n_row_tiles
        K = x.shape[1]

        def _build() -> StructureEntry:
            if self.faults is not None:
                self.faults.probe("pack", detail=f"stripes:{nrt}")
            rows, cols, vals = host(x.rows), host(x.cols), host(x.vals)
            order = np.argsort(rows, kind="stable")
            rows, cols, vals = rows[order], cols[order], vals[order]
            bounds = np.searchsorted(rows, np.arange(nrt + 1) * tm)
            stripes = {}
            for i in range(nrt):
                lo, hi = bounds[i], bounds[i + 1]
                stripes[i] = pack_blockcsr_coo(
                    (plan.part.row_extent(i), K),
                    rows[lo:hi] - i * tm, cols[lo:hi], vals[lo:hi],
                    self.block, eps=self.eps, device=self.device)
            return StructureEntry(stripes=stripes)

        key = plan.struct_key + (self.block,)
        return key, self.cache.structure(key, _build)

    def _ensure_dense(self, key: tuple, entry: StructureEntry,
                      x: SparseCOO) -> torch.Tensor:
        """Materialize the densified operand on first need (a plan routed
        tasks of this operand to the dense engine) and re-account its bytes.
        A graph-scale adjacency whose plan is all-sparse never gets here."""
        if entry.dense is None:
            entry.dense = torch.as_tensor(x.todense(), device=self.device)
            self.cache.recharge(PlanCache._STRUCT, key)
        return entry.dense

    def dispatch_for(self, plan: KernelPlan,
                     x) -> "_dispatch.CompiledDispatch | None":
        """The plan's :class:`CompiledDispatch` (cached; lowered on first
        need), or ``None`` when the kernel is not compilable: non-literal
        engines, uncacheable (dense X) operands, canvas-misaligned geometry,
        or a mesh engine (it lowers through :meth:`sharded_dispatch_for`,
        even at mesh size 1)."""
        if not (self.literal and self.batched) or self.mesh is not None:
            return None
        if not isinstance(x, SparseCOO) or plan.struct_key is None:
            return None
        if _dispatch.canvas_slots(plan.part, self.block) is None:
            return None
        _, entry = self._packed_structure(plan, x)
        digest = _dispatch.plan_digest(plan, self.block)
        return self.cache.dispatch(
            (plan.struct_key, digest),
            lambda: _dispatch.build_dispatch(
                plan.part, plan.stq, plan.dtq, entry.stripes,
                block=self.block, eps=self.eps, fingerprint=digest,
                faults=self.faults))

    def sharded_dispatch_for(
            self, plan: KernelPlan,
            x) -> "_shard_exec.ShardedDispatch | None":
        """The placed plan's
        :class:`~repro_torch.core.shard_exec.ShardedDispatch` (cached;
        lowered on first need, each shard's slice uploaded to its mesh
        device then), or ``None`` when the kernel is not compilable — the
        decline conditions of :meth:`dispatch_for`, plus a plan without a
        placement (made by a single-device engine)."""
        if self.mesh is None or not (self.literal and self.batched):
            return None
        if not isinstance(x, SparseCOO) or plan.struct_key is None:
            return None
        if plan.placement is None:
            return None
        if _dispatch.canvas_slots(plan.part, self.block) is None:
            return None
        _, entry = self._packed_structure(plan, x)
        digest = _dispatch.plan_digest(plan, self.block)
        return self.cache.sharded_dispatch(
            (plan.struct_key, digest, self.n_devices, self.operand_sharding),
            lambda: _shard_exec.build_sharded_dispatch(
                plan.part, plan.stq, plan.dtq, entry.stripes, plan.placement,
                block=self.block, eps=self.eps, fingerprint=digest,
                operand_sharding=self.operand_sharding, faults=self.faults,
                devices=self.mesh.devices))

    def activation_dispatch_for(
            self, plan: KernelPlan, x, *, capacity=None,
            slack: float = 1.5,
            per_stripe: bool = True) -> "_dispatch.ActivationDispatch | None":
        """The plan's :class:`~repro_torch.core.dispatch.ActivationDispatch`
        — the capacity-padded block-skip route for a dense (activation-side)
        X — or ``None`` when the kernel should stay dense: non-literal or
        non-batched engines, sparse X (that is :meth:`dispatch_for`'s job),
        plans whose Analyzer routed every task to the dense engine, or
        canvas-misaligned geometry.

        ``capacity`` fixes the stored-block budget (an int, or a per-stripe
        vector); by default it is measured from ``x`` (the warmup
        activation) with ``slack`` headroom, per stripe
        (``dispatch.activation_budgets``) or, with ``per_stripe=False``, as
        one uniform max-need budget.  Descriptors are content-INDEPENDENT:
        cached on the plan digest, the budget and eps."""
        if not (self.literal and self.batched):
            return None
        if isinstance(x, SparseCOO) or not plan.stq:
            return None
        if capacity is None:
            sizer = (_dispatch.activation_budgets if per_stripe
                     else _dispatch.activation_capacity)
            capacity = sizer(x, plan.part, self.block, eps=self.eps,
                             slack=slack)
            if capacity is None:
                return None
        cap_key = (tuple(int(c) for c in np.asarray(capacity).ravel())
                   if np.ndim(capacity) else int(capacity))
        digest = _dispatch.plan_digest(plan, self.block)
        return self.cache.activation_dispatch(
            (digest, cap_key, self.eps),
            lambda: _dispatch.build_activation_dispatch(
                plan.part, plan.stq, plan.dtq, block=self.block,
                capacity=capacity, eps=self.eps, fingerprint=digest,
                device=self.device, faults=self.faults))

    def compiled_operands(
            self, plan: KernelPlan,
            x) -> "tuple[_dispatch.CompiledDispatch, torch.Tensor | None] | None":
        """(dispatch, densified-x-or-None) for a plan, or ``None`` when the
        kernel is not compilable."""
        d = self.dispatch_for(plan, x)
        if d is None:
            return None
        xd = None
        if d.needs_x:
            key, entry = self._packed_structure(plan, x)
            xd = self._ensure_dense(key, entry, x)
        return d, xd

    def sharded_operands(
            self, plan: KernelPlan,
            x) -> "tuple[_shard_exec.ShardedDispatch, torch.Tensor | None] | None":
        """(sharded dispatch, densified-x-or-None) for a placed plan, or
        ``None`` when not compilable — the mesh counterpart of
        :meth:`compiled_operands`."""
        sd = self.sharded_dispatch_for(plan, x)
        if sd is None:
            return None
        xd = None
        if sd.needs_x:
            key, entry = self._packed_structure(plan, x)
            xd = self._ensure_dense(key, entry, x)
        return sd, xd

    def execute(self, plan: KernelPlan, x, y) -> torch.Tensor:
        """Functional result of a planned kernel (no re-analysis).

        Literal engines prefer the compiled dispatch (descriptors served
        from the cache); kernels the compiler declines take the eager
        batched drain (or the per-task path when ``batched=False``)."""
        if self.faults is not None:
            self.faults.probe("execute", detail=plan.part.name)
        x = self._operand(x)
        y = as_tensor(y, self.device)
        if self.literal:
            if self.mesh is not None:
                spair = self.sharded_operands(plan, x)
                if spair is not None:
                    sd, xd = spair
                    return _shard_exec.execute_sharded(
                        sd, xd, y, mesh=self.mesh, stats=self.cache.stats,
                        faults=self.faults)
            pair = self.compiled_operands(plan, x)
            if pair is not None:
                d, xd = pair
                return _dispatch.execute_dispatch(d, xd, y,
                                                  stats=self.cache.stats)
            packed = None
            if isinstance(x, SparseCOO):
                if plan.struct_key is not None:
                    key, entry = self._packed_structure(plan, x)
                    packed = entry.stripes
                    # the densified operand is only needed by dense-engine
                    # tasks (batched GEMM gather) or the per-task path
                    xd = (self._ensure_dense(key, entry, x)
                          if plan.dtq or not self.batched else None)
                else:
                    xd = torch.as_tensor(x.todense(), device=self.device)
            else:
                xd = x
            return _scheduler.execute_plan(
                plan.part, plan.stq, plan.dtq, xd, y,
                block=self.block, batched=self.batched, packed=packed,
                eps=self.eps)
        if isinstance(x, SparseCOO):
            return prim.spdmm_exec(x, y)
        return prim.gemm_exec(x, y)

    # ------------------------------------------------------------------
    def matmul(self, x, y, name: str = "kernel"):
        """Z = X · Y through the runtime system.  ``x`` may be ``SparseCOO``
        (graph adjacency) or a dense tensor; ``y`` is dense."""
        y = as_tensor(y, self.device)
        plan = self.plan(x, y, name=name)
        rep = plan.report
        self.report.kernels.append((name, rep))
        self.report.meta.append({
            "name": name,
            "M": plan.part.M, "K": plan.part.K, "N": plan.part.N,
            "x_is_adj": isinstance(x, SparseCOO) and x.tag == "adjacency",
            "alpha_x": float(np.mean(plan.row_density)),
            "alpha_y": float(np.mean(plan.col_density)),
        })
        z = self.execute(plan, x, y)
        return z, rep
