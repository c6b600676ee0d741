"""ServingEngine — async micro-batched GNN inference.

The front-end of the serving subsystem: concurrent requests against the
same registered graph are coalesced into one stacked feature matrix and
served with ONE plan/execute pass per model kernel — GraphAGILE's overlay
insight (batch requests through a compiled kernel sequence instead of
replaying the whole pipeline per request) on top of the SharedPlanCache's
amortized preprocessing.

Batching math: a GNN layer is matmuls plus element-wise ops, so ``k``
requests' feature matrices ``h_r`` (each ``N x d``) stack column-wise into
``H = [h_1 | ... | h_k]`` (``N x k·d``).  Aggregation ``Â · H`` distributes
over the column blocks directly; transformation ``H · W`` is computed by
unstacking to ``(k·N, d)`` row form around a single engine matmul.  Block
``r`` of every intermediate therefore equals the per-request computation
bit-for-bit — micro-batched results match ``run_reference`` per request.

Request lifecycle::

    submit ──► per-graph queue ──► micro-batch (≤ max_batch, ≤ max_delay)
           ──► pad to the max_batch stacked width (single-plan serving)
           ──► density sketch revalidates cached plan (replan on drift)
           ──► one plan/execute pass on the dispatch worker thread
           ──► outputs split per request, futures resolved, stats recorded

The plan/execute pass runs on a dedicated single-worker executor, NOT on
the event loop: while a batch computes, the loop keeps accepting and
coalescing the next burst.  Padding partial batches to ``max_batch`` keeps
the engine's kernel geometry constant across traffic shapes, so every
registered graph plans exactly once per distinct model kernel (the
GraphAGILE compile-once/serve-many overlay property).

Degraded-mode serving (the failure half of the lifecycle)::

    compiled program fails   ──► eager batched fallback (degraded_batches)
    eager batch fails        ──► bisect into halves (bisections) until the
                                 poison request fails ALONE
    single request fails     ──► bounded backoff retries (retries), then
                                 quarantine (quarantined) — its future
                                 carries the error, neighbours are served
                                 bit-identically to a fault-free run
    batch straggles/wedges   ──► per-request deadline fails the caller with
                                 DeadlineExceeded (deadline_expired)
    drift→recompile churn    ──► per-graph circuit breaker pins the
                                 last-good program through a cooldown
                                 (breaker_trips)

Fault sites for chaos testing are instrumented throughout (see
serving/faults.py); the dispatch worker heartbeats a
``distributed.fault.FaultMonitor`` exposed via
``dispatch_stats()["health"]``.

Threads and the card: :meth:`ServingEngine.infer` runs on the event loop
and keeps each caller's features as given.  Every device operation of
serving — the upload, stacking, padding, the compiled program's capture and
replay, and the split — runs on the single dispatch worker, because a CUDA
graph captured there (``torch.cuda.graph``'s global capture mode) breaks if
another thread touches the device meanwhile.  Per-request results are
column slices of a batch's logits, which a compiled program returns as a
copy of its static output, so a later replay never overwrites an earlier
caller's result.

``ServingConfig.n_devices`` serves through a mesh engine over the first
``n_devices`` devices of the cache's type
(:func:`repro_torch.launch.mesh.make_data_mesh`), literal and batched, with
``operand_sharding`` as the dense operand's distribution.
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.engine import DynasparseEngine, EngineReport
from repro_torch.core.primitives import SparseCOO
from repro_torch.device import as_tensor
from repro_torch.distributed.fault import FaultMonitor
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import gnn
from repro_torch.serving.cache import (GraphKey, SharedPlanCache,
                                       get_shared_cache)
from repro_torch.serving.faults import DeadlineExceeded, FaultInjector
from repro_torch.serving.sketch import SketchConfig
from repro_torch.trace import span


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Micro-batching + revalidation policy of one ServingEngine.

    ``pad_to_max_batch`` (default on) pads a partial micro-batch's stacked
    feature matrix to the ``max_batch`` width before dispatch (replicating
    the batch's own feature columns — see ``_dispatch``) and slices the
    padding columns away on split.  The engine then sees ONE stacked width
    per graph/kernel regardless of traffic shape, so the plan cache holds
    exactly one plan per graph and model kernel — instead of one per
    distinct batch size — and the density sketch never sees a
    traffic-shape-dependent operand.  Column blocks are independent through
    the model zoo (matmuls + element-wise ops), so per-request results are
    unchanged.
    """
    max_batch: int = 8            # requests coalesced per dispatch
    max_delay_s: float = 0.0      # batching window after the first request
    sketch: SketchConfig = SketchConfig()
    pad_to_max_batch: bool = True  # single-plan serving (see class docstring)
    # Whole-model compiled dispatch (default on): the first micro-batch of a
    # (graph, stacked shape) runs eagerly — planning, packing and lowering
    # every kernel — and doubles as the warmup pass of
    # ``models.gnn.compile_model``; every later batch is ONE compiled call
    # (a CUDA-graph replay on the card) with zero host descriptor work.  The input-density sketch invalidates the
    # compiled program on drift (the eager re-run replans, then recompiles).
    # Engines the compiler declines (non-literal, misaligned geometry,
    # eps-thresholded SpMM) transparently stay eager.
    compile_models: bool = True
    # Bound on retained compiled programs (insertion-order eviction): the
    # registry pins descriptor/operand arrays outside the byte-accounted
    # plan cache, so a many-graph engine must not grow it without limit.
    max_compiled: int = 32
    # Sparse-activation block-skip inside compiled programs: activation-side
    # kernels whose warmup plan routed tasks to the sparse engine run on the
    # capacity-padded BlockCSR route (fixed stored-block budget =
    # ``activation_slack`` headroom over the warmup's measured blocks;
    # overflow falls back to a dense GEMM inside the same program).  Off →
    # every activation kernel is one dense ``gemm`` kernel.
    activation_skip: bool = True
    activation_slack: float = 1.5
    # per-stripe capacity budgets (each stripe sized from its own warmup
    # need × slack) instead of one uniform max-need budget — cuts padded-
    # slot waste on skewed activations; off restores the uniform budget.
    activation_per_stripe: bool = True
    # Multi-device dispatch: shard each graph's row-stripe bands over a 1-D
    # ("data",) mesh of this many devices (None = single-device engine).
    # The constructed engine is literal and batched (the sharded path is a
    # compiled-dispatch route) and plans with a two-level (device, queue)
    # placement.  Needs that many visible devices (``make_data_mesh``
    # raises otherwise).
    n_devices: int | None = None
    # Dense-operand distribution of the sharded executor: "halo" (default)
    # ships each shard its owned block-rows plus the halo its band reads;
    # "replicate" ships the whole operand (the bitwise oracle).  Ignored
    # without ``n_devices``.
    operand_sharding: str = "halo"
    # ---- degraded-mode serving (fault tolerance policy) -----------------
    # Per-request retry budget once a request has been isolated by the
    # bisection ladder (a failed micro-batch is split in halves until the
    # poison request fails alone); exhausted retries quarantine the request
    # — its future resolves with the error, neighbours are untouched.
    max_retries: int = 1
    # Base of the exponential backoff between per-request retries (seconds,
    # slept on the dispatch worker; attempt ``i`` sleeps ``base * 2**i``).
    retry_backoff_s: float = 0.0
    # Per-request deadline: ``infer()`` raises ``DeadlineExceeded`` (and
    # records the request with a structured error) instead of waiting
    # forever on a straggling batch.  None = no deadline.
    request_timeout: float | None = None
    # Circuit breaker over drift→replan→recompile churn: more than
    # ``breaker_threshold`` compiled-program invalidation events within
    # ``breaker_window_s`` trips the graph's breaker for
    # ``breaker_cooldown_s`` — the last-good compiled program is pinned
    # (drift checks and eager replans suppressed) until the cooldown ends.
    breaker_threshold: int = 3
    breaker_window_s: float = 60.0
    breaker_cooldown_s: float = 30.0
    # Chaos hook: a seeded ``serving.faults.FaultInjector`` threaded through
    # the engine, plan cache and compiled programs.  None (default) = every
    # probe is a no-op attribute check.
    faults: FaultInjector | None = None


@dataclasses.dataclass
class RequestStats:
    """Per-request observability record (latency and queue depth)."""
    request_id: int
    graph_id: str
    queue_depth: int              # requests already waiting at enqueue
    batch_size: int = 0           # real requests in the micro-batch (no pad)
    t_queue: float = 0.0          # seconds from enqueue to dispatch
    t_execute: float = 0.0        # micro-batch execute wall (shared)
    latency: float = 0.0          # enqueue -> result available
    report: EngineReport | None = None   # per-request share of the batch
                                         # report (EngineReport.attributed)
    error: str | None = None      # set when the request's batch failed


@dataclasses.dataclass
class ServingStats:
    requests: list[RequestStats] = dataclasses.field(default_factory=list)
    batches: int = 0
    compiled_batches: int = 0     # batches served by a CompiledModel call
    compile_invalidations: int = 0  # compiled programs dropped on input drift
    # raw (unattributed) engine report of every SUCCESSFUL micro-batch, in
    # dispatch order — the per-request `RequestStats.report` is a 1/k share.
    # Failed batches count in `batches` but carry no engine report (their
    # requests are visible via `RequestStats.error`), so len(batch_reports)
    # == batches - failed batches.
    batch_reports: list[EngineReport] = dataclasses.field(default_factory=list)
    # COMPILED batches with activation-route kernels, and running aggregates
    # of their block-skip telemetry (``_activation_summary``, summed over
    # each batch's activation kernels)
    activation_batches: int = 0
    act_overflows: int = 0
    act_skipped_sum: float = 0.0
    act_kernels_last: int = 0
    # ---- degraded-mode telemetry ----------------------------------------
    degraded_batches: int = 0   # compiled call failed → eager fallback served
    bisections: int = 0         # failed micro-batch splits (ladder descents)
    retries: int = 0            # isolated per-request retry attempts
    quarantined: int = 0        # requests failed alone after retry budget
    breaker_trips: int = 0      # drift-churn circuit-breaker activations
    deadline_expired: int = 0   # requests failed by request_timeout

    def record_activation(self, summary: dict) -> None:
        self.activation_batches += 1
        self.act_overflows += summary["overflows"]
        self.act_skipped_sum += summary["skipped_ratio"]
        self.act_kernels_last = summary["kernels"]

    def latency_percentiles(self) -> dict:
        if not self.requests:
            return {"p50": 0.0, "p95": 0.0, "mean": 0.0}
        lat = np.array([r.latency for r in self.requests])
        return {"p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95)),
                "mean": float(lat.mean())}

    @property
    def mean_batch_size(self) -> float:
        if not self.requests:
            return 0.0
        return len(self.requests) / max(1, self.batches)

    @property
    def errors(self) -> int:
        return sum(1 for r in self.requests if r.error is not None)

    def as_dict(self) -> dict:
        return {"requests": len(self.requests), "batches": self.batches,
                "compiled_batches": self.compiled_batches,
                "compile_invalidations": self.compile_invalidations,
                "errors": self.errors,
                "degraded_batches": self.degraded_batches,
                "bisections": self.bisections,
                "retries": self.retries,
                "quarantined": self.quarantined,
                "breaker_trips": self.breaker_trips,
                "deadline_expired": self.deadline_expired,
                "mean_batch_size": self.mean_batch_size,
                "latency": self.latency_percentiles()}


@dataclasses.dataclass
class _Request:
    features: object               # as the caller gave it (see module doc)
    future: asyncio.Future
    stats: RequestStats
    t_enqueue: float
    # set once the request's RequestStats has been appended (loop OR worker
    # thread may get there first — deadline expiry races batch completion)
    recorded: bool = False
    # set when the caller stopped waiting (deadline): the dispatcher drops
    # the request instead of spending a batch slot on an abandoned future
    abandoned: bool = False


def stacked_transport(mm: gnn.MM) -> gnn.MM:
    """Wrap an abstract matmul with the stacked-representation transport.

    Sparse x (aggregation): the stacked ``(N, k·d)`` operand feeds one
    kernel — aggregation distributes over the column blocks directly.
    Dense x (transformation): the stacked operand is unstacked to row form
    ``(k·N, d_in)`` around one kernel, so weights are never
    block-diagonalized.  ``k`` is recovered from the width ratio, so the
    same ``mm`` serves every layer of every model.  Device operations only
    (reshapes and copies, no host read), so the whole-model compiler reuses
    it inside a captured program.
    """
    def wrapped(x, y, name: str = "kernel"):
        if isinstance(x, SparseCOO):
            return mm(x, y, name=name)
        d_in = y.shape[0]
        if x.shape[1] == d_in:          # unstacked (k == 1) — plain kernel
            return mm(x, y, name=name)
        if x.shape[1] % d_in:
            raise ValueError(
                f"stacked width {x.shape[1]} is not a multiple of the "
                f"weight fan-in {d_in}")
        k = x.shape[1] // d_in
        n = x.shape[0]
        xr = x.reshape(n, k, d_in).transpose(0, 1).reshape(k * n, d_in)
        z = mm(xr, y, name=name)
        d_out = y.shape[1]
        return z.reshape(k, n, d_out).transpose(0, 1).reshape(n, k * d_out)
    return wrapped


def _activation_summary(diags: list[dict]) -> dict:
    """Aggregate one compiled batch's per-kernel activation telemetry into
    host numbers.  Runs after the replay (never inside a capture); the
    device scalars come back in ONE transfer, not a sync per field."""
    dev_vals = torch.stack([
        torch.stack([d["stored"].to(torch.int64),
                     d["overflow"].to(torch.int64)])
        for d in diags]).tolist()
    stored = sum(v[0] for v in dev_vals)
    overflows = sum(int(v[1] != 0) for v in dev_vals)
    capacity = sum(int(d["capacity"]) for d in diags)
    logical = sum(int(d["logical"]) for d in diags)
    return {
        "kernels": len(diags),
        "stored_blocks": stored,
        "capacity_blocks": capacity,
        "logical_blocks": logical,
        "overflows": overflows,
        "skipped_ratio": 1.0 - stored / max(1, logical),
    }


def batched_mm(engine: DynasparseEngine) -> gnn.MM:
    """The stacked-representation matmul the model zoo is applied against
    (the eager path: every kernel goes through ``engine.matmul``)."""
    return stacked_transport(gnn.engine_mm(engine))


class ServingEngine:
    """Async micro-batching front-end over one DynasparseEngine.

    One instance serves ONE model (name + params) over any number of
    registered graphs; the plan cache is the process-wide
    :func:`get_shared_cache` unless an engine/cache is supplied, so
    independent ServingEngines still share packed adjacencies.  A default
    engine is the non-literal ``DynasparseEngine`` on the cache's device
    (COO ``index_add_`` and ``torch.matmul``); pass
    ``DynasparseEngine(literal=True, cache=...)`` to serve through the
    fused kernels.  An engine on another device than its
    ``SharedPlanCache`` is refused.
    """

    def __init__(
        self,
        model: str,
        params: dict,
        engine: DynasparseEngine | None = None,
        *,
        config: ServingConfig = ServingConfig(),
        cache: SharedPlanCache | None = None,
    ):
        if model not in gnn.MODELS:
            raise ValueError(f"unknown model {model!r} (have {gnn.MODELS})")
        self.model = model
        self.params = params
        self.config = config
        self.faults = config.faults
        if engine is None:
            # `is None`, not `or`: an empty PlanCache is falsy (__len__)
            shared = cache if cache is not None else get_shared_cache()
            if config.n_devices is not None:
                # mesh serving implies the literal batched engine: a
                # non-literal mesh engine would run single-device eagerly
                engine = DynasparseEngine(
                    cache=shared, faults=config.faults, device=shared.device,
                    mesh=make_data_mesh(config.n_devices,
                                        device=shared.device),
                    literal=True, batched=True,
                    operand_sharding=config.operand_sharding)
            else:
                engine = DynasparseEngine(cache=shared, faults=config.faults,
                                          device=shared.device)
        elif config.n_devices is not None and (
                engine.n_devices != config.n_devices):
            raise ValueError(
                f"ServingConfig.n_devices={config.n_devices} conflicts with "
                f"the supplied engine's mesh ({engine.n_devices} device(s)); "
                f"pass one or the other")
        elif (isinstance(engine.cache, SharedPlanCache)
              and engine.cache.device != engine.device):
            raise ValueError(
                f"engine on {engine.device}, its SharedPlanCache on "
                f"{engine.cache.device}: restored entries would land on the "
                "wrong device")
        # the sketch policy is applied around each dispatch, never left on a
        # caller-supplied engine (no hidden mutation outliving the serve)
        self.engine = engine
        if config.faults is not None:
            # chaos runs own their engine/cache: thread the injector through
            # so the instrumented plan/lower/pack/execute/snapshot sites fire
            self.engine.faults = config.faults
            if isinstance(self.engine.cache, SharedPlanCache):
                self.engine.cache.faults = config.faults
        self.stats = ServingStats()
        # RequestStats may be appended from the event loop (deadline expiry)
        # and the dispatch worker (batch completion) — same request, two
        # threads.  The lock plus _Request.recorded makes recording
        # exactly-once.
        self._stats_lock = threading.RLock()
        self._graphs: dict[str, SparseCOO] = {}
        self._queues: dict[str, collections.deque[_Request]] = {}
        self._draining: set[str] = set()
        # drift-churn circuit breakers, one per graph:
        # {events deque[monotonic], open_until, trips}
        self._breakers: dict[str, dict] = {}
        # dispatch-worker liveness/straggler surface: every micro-batch
        # heartbeats with its step time; dispatch_stats()["health"] exposes
        # the snapshot (distributed/fault.py doubles as the in-process
        # worker monitor)
        self._monitor = FaultMonitor(["dispatch-0"], timeout=60.0)
        # compiled whole-model programs, one per (graph, stacked shape,
        # dtype) — with pad_to_max_batch that is ONE program per graph
        self._compiled: dict[tuple, gnn.CompiledModel] = {}
        self._next_id = 0
        # ONE dispatch worker: micro-batches compute off the event loop (the
        # loop keeps coalescing the next burst), serialized so the shared
        # DynasparseEngine's report/sketch state is never touched twice at
        # once.
        self._dispatch_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-dispatch")

    def dispatch_stats(self) -> dict:
        """Compiled-path observability: the plan/dispatch/trace counters of
        the underlying cache plus this engine's compiled-program registry
        (the dispatch benchmark's acceptance surface)."""
        s = self.engine.cache.stats
        st = self.stats
        n_act = st.activation_batches
        return {
            "plans": self.engine.cache.plan_count(),
            "n_devices": self.engine.n_devices,
            "sharded_dispatches": self.engine.cache.sharded_count(),
            "operand_sharding": self.engine.operand_sharding,
            # per-shard dense-operand memory of the sharded dispatches
            # (owned / halo / replicated-fallback bytes)
            "operand_bytes": self.engine.cache.sharded_operand_bytes(),
            "dispatch_builds": s.dispatch_builds,
            "dispatch_hits": s.dispatch_hits,
            "act_builds": s.act_builds,
            "act_hits": s.act_hits,
            "calib_builds": s.calib_builds,
            "calib_hits": s.calib_hits,
            "trace_builds": s.trace_builds,
            "trace_cache_hits": s.trace_cache_hits,
            "replans": s.replans,
            "compiled_models": len(self._compiled),
            # adjacency kernels of the compiled models, and those of them
            # on the in-place sparse body (``CompiledModel.n_inplace``)
            "adjacency_kernels": sum(cm.n_sparse
                                     for cm in self._compiled.values()),
            "inplace_kernels": sum(cm.n_inplace
                                   for cm in self._compiled.values()),
            "compiled_batches": st.compiled_batches,
            # sparse-activation route telemetry (running aggregates)
            "act_kernels_last": st.act_kernels_last,
            "act_overflows": st.act_overflows,
            "act_skipped_ratio_mean": (st.act_skipped_sum / n_act
                                       if n_act else 0.0),
            # degraded-mode telemetry + snapshot robustness
            "degraded_batches": st.degraded_batches,
            "bisections": st.bisections,
            "retries": st.retries,
            "quarantined": st.quarantined,
            "breaker_trips": st.breaker_trips,
            "deadline_expired": st.deadline_expired,
            "snapshot_errors": s.snapshot_errors,
            # dispatch-worker heartbeat/straggler view (FaultMonitor)
            "health": self._monitor.snapshot(),
        }

    def close(self) -> None:
        """Shut down the dispatch worker thread.  Call when retiring the
        engine (or use it as a context manager); long-lived processes that
        build engines per model/tenant would otherwise accumulate idle
        threads.  Idempotent; in-flight batches finish first."""
        self._dispatch_pool.shutdown(wait=True)

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- graphs
    def register_graph(self, graph_id: str, adj: SparseCOO) -> GraphKey:
        """Make ``graph_id`` servable.  Returns the content key; when the
        engine's cache is a SharedPlanCache the key is also recorded in its
        registry (persistence manifest / observability)."""
        if self._graphs.get(graph_id) is not adj:
            # a re-registered id may carry a DIFFERENT graph: compiled
            # whole-model programs bake the old adjacency's descriptors in,
            # and the input-density drift check cannot see an adjacency
            # swap — drop them so the next batch recompiles against adj
            for k in [k for k in self._compiled if k[0] == graph_id]:
                del self._compiled[k]
        self._graphs[graph_id] = adj
        self._queues.setdefault(graph_id, collections.deque())
        if isinstance(self.engine.cache, SharedPlanCache):
            return self.engine.cache.register_graph(graph_id, adj)
        return GraphKey.of(adj)

    # ------------------------------------------------------------ requests
    async def infer(self, graph_id: str, features) -> torch.Tensor:
        """Submit one request and await its logits.  Concurrent callers on
        the same graph are coalesced into one micro-batch.  ``features``
        (a numpy array, or a tensor on the engine's device) is kept as
        given: the dispatch worker uploads and stacks it.

        With ``config.request_timeout`` set, a request that is still
        unresolved at the deadline raises :class:`DeadlineExceeded` and is
        recorded with a structured ``RequestStats.error`` — a straggling or
        wedged batch fails the caller fast instead of hanging ``serve()``.
        """
        if graph_id not in self._graphs:
            raise KeyError(f"graph {graph_id!r} is not registered")
        loop = asyncio.get_running_loop()
        q = self._queues[graph_id]
        stats = RequestStats(request_id=self._next_id, graph_id=graph_id,
                             queue_depth=len(q))
        self._next_id += 1
        req = _Request(features=features,
                       future=loop.create_future(), stats=stats,
                       t_enqueue=time.perf_counter())
        q.append(req)
        if graph_id not in self._draining:
            self._draining.add(graph_id)
            asyncio.ensure_future(self._drain(graph_id))
        timeout = self.config.request_timeout
        if timeout is None:
            return await req.future
        try:
            # wait_for cancels the future on expiry; _resolve's done() guard
            # makes a late worker-side resolution a harmless no-op
            return await asyncio.wait_for(req.future, timeout)
        except asyncio.TimeoutError:
            req.abandoned = True
            now = time.perf_counter()
            exc = DeadlineExceeded(
                f"request {stats.request_id} on graph {graph_id!r} missed "
                f"its {timeout}s deadline")
            with self._stats_lock:
                self.stats.deadline_expired += 1
            self._record_request(req, t0=now, t1=now,
                                 batch_size=req.stats.batch_size,
                                 error=f"{type(exc).__name__}: {exc}")
            raise exc from None

    async def _drain(self, graph_id: str) -> None:
        """Per-graph dispatcher: opened by the first request of a burst,
        closes when the queue runs dry.  The dry-check and the ``_draining``
        hand-back happen on the loop without an await between them, so a
        queue can never strand a request.  The compute itself is handed to
        the dispatch worker thread — the loop stays free to accept and
        coalesce the next burst while a batch executes."""
        loop = asyncio.get_running_loop()
        q = self._queues[graph_id]
        try:
            while q:
                if (len(q) < self.config.max_batch
                        and self.config.max_delay_s > 0):
                    await asyncio.sleep(self.config.max_delay_s)
                else:
                    await asyncio.sleep(0)   # let same-tick submitters land
                batch = [q.popleft()
                         for _ in range(min(len(q), self.config.max_batch))]
                # deadline-abandoned requests are already recorded/failed —
                # don't spend batch slots (or fault probes) on them
                batch = [r for r in batch if not r.abandoned]
                if batch:
                    try:
                        await loop.run_in_executor(
                            self._dispatch_pool, self._dispatch,
                            graph_id, batch)
                    except Exception as exc:
                        # anything _dispatch's own handling didn't catch
                        # (errors before its try block, a shut-down
                        # executor, ...) must still fail the popped batch's
                        # futures — stranding them deadlocks serve()
                        self._fail_batch(batch, time.perf_counter(), exc)
        finally:
            self._draining.discard(graph_id)

    @staticmethod
    def _resolve(fut: asyncio.Future, *, result=None, exc=None) -> None:
        """Resolve a future from any thread.  ``_dispatch`` runs on the
        worker executor, where ``Future.set_result`` is not thread-safe —
        hand the resolution to the future's own loop in that case."""
        def _set() -> None:
            if fut.done():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        loop = fut.get_loop()
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            _set()
        else:
            loop.call_soon_threadsafe(_set)

    def _record_request(self, r: _Request, *, t0: float, t1: float,
                        batch_size: int, report=None,
                        error: str | None = None) -> bool:
        """Append one request's stats exactly once (loop-side deadline
        expiry and worker-side batch completion may race to record the same
        request).  Returns False when someone else already recorded it."""
        with self._stats_lock:
            if r.recorded:
                return False
            r.recorded = True
            r.stats.batch_size = batch_size
            r.stats.t_queue = t0 - r.t_enqueue
            r.stats.t_execute = t1 - t0
            r.stats.latency = t1 - r.t_enqueue
            r.stats.report = report
            r.stats.error = error
            self.stats.requests.append(r.stats)
            return True

    def _fail_batch(self, batch: list[_Request], t0: float,
                    exc: Exception) -> None:
        """Fail every request of a batch AND record it: failed traffic must
        show up in ``requests``/``mean_batch_size`` (with ``error`` set),
        not silently undercount the stats."""
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.batches += 1
        # record EVERY request before resolving ANY future: gather() raises
        # on the first exception, so a caller can observe stats the moment
        # one future fails — interleaving would undercount the batch
        self._monitor.heartbeat("dispatch-0", step_time=t1 - t0)
        for r in batch:
            self._record_request(r, t0=t0, t1=t1, batch_size=len(batch),
                                 error=f"{type(exc).__name__}: {exc}")
        for r in batch:
            self._resolve(r.future, exc=exc)

    # ------------------------------------------------------ circuit breaker
    def _breaker(self, graph_id: str) -> dict:
        return self._breakers.setdefault(
            graph_id,
            {"events": collections.deque(), "open_until": 0.0, "trips": 0})

    def _breaker_open(self, graph_id: str) -> bool:
        b = self._breakers.get(graph_id)
        return b is not None and time.monotonic() < b["open_until"]

    def _breaker_event(self, graph_id: str) -> bool:
        """Record one compiled-program invalidation event.  Returns True
        when this event TRIPS the breaker: the caller then pins the
        last-good program through the cooldown instead of invalidating —
        bounding drift→replan→recompile churn when inputs oscillate around
        the drift threshold."""
        b = self._breaker(graph_id)
        now = time.monotonic()
        ev = b["events"]
        ev.append(now)
        while ev and now - ev[0] > self.config.breaker_window_s:
            ev.popleft()
        if len(ev) >= self.config.breaker_threshold:
            b["open_until"] = now + self.config.breaker_cooldown_s
            b["trips"] += 1
            ev.clear()
            with self._stats_lock:
                self.stats.breaker_trips += 1
            return True
        return False

    # ------------------------------------------------- degradation ladder
    def _dispatch(self, graph_id: str, batch: list[_Request]) -> None:
        """Worker-thread entry for one micro-batch: run the degradation
        ladder.  Per-step times are heartbeated from the resolution sites
        (``_execute_batch`` / ``_fail_batch``) BEFORE any future resolves —
        the ``dispatch_stats()["health"]`` surface must show a batch by the
        time its caller unblocks.  The epilogue heartbeat here is
        liveness-only (no step time) so steps aren't double-counted."""
        try:
            batch = [r for r in batch
                     if not (r.abandoned or r.future.done())]
            if batch:
                self._serve_batch(graph_id, batch)
        finally:
            self._monitor.heartbeat("dispatch-0")

    def _serve_batch(self, graph_id: str, batch: list[_Request],
                     attempt: int = 0) -> None:
        """One rung of the degradation ladder.

        Try the batch as a unit (``_execute_batch`` internally degrades a
        failed compiled program to the eager path first).  If the whole
        attempt still fails, bisect: each half retries independently, so a
        poison request descends the ladder alone while its neighbours are
        re-served bit-identically (pad_to_max_batch keeps the kernel
        geometry — and therefore each request's column block — independent
        of batch composition).  A request failing alone gets
        ``max_retries`` backoff retries (transient faults recover), then is
        quarantined: ITS future carries the error, nobody else's.
        """
        t0 = time.perf_counter()
        try:
            if self.faults is not None:
                self.faults.probe("dispatch", detail=graph_id)
                for r in batch:
                    # ';' terminates the id so match="req:1;" can never
                    # poison request 11 as well
                    self.faults.probe(
                        "request", detail=f"req:{r.stats.request_id};")
            self._execute_batch(graph_id, batch, t0)
            return
        except Exception as exc:
            err = exc
        if len(batch) > 1:
            with self._stats_lock:
                self.stats.bisections += 1
            mid = len(batch) // 2
            self._serve_batch(graph_id, batch[:mid])
            self._serve_batch(graph_id, batch[mid:])
            return
        if attempt < self.config.max_retries:
            with self._stats_lock:
                self.stats.retries += 1
            if self.config.retry_backoff_s > 0:
                time.sleep(self.config.retry_backoff_s * (2 ** attempt))
            self._serve_batch(graph_id, batch, attempt=attempt + 1)
            return
        with self._stats_lock:
            self.stats.quarantined += 1
        self._fail_batch(batch, t0, err)

    def _execute_batch(self, graph_id: str, batch: list[_Request],
                       t0: float) -> None:
        with span("serving.batch"):
            self._run_batch(graph_id, batch, t0)

    def _run_batch(self, graph_id: str, batch: list[_Request],
                   t0: float) -> None:
        """Serve one micro-batch: stack → pad → one engine pass → split.

        Runs on the single dispatch worker thread; futures are resolved
        back on their loop.  Raises on failure — the ladder above decides
        whether to bisect, retry or quarantine.  One degradation happens
        HERE: a compiled program that fails mid-call falls back to the
        eager batched path for this batch (``degraded_batches``), keeping
        the program for the next batch (a transient executor fault should
        not force a recompile).
        """
        adj = self._graphs[graph_id]
        k = len(batch)
        with span("serving.stack"):
            feats = [as_tensor(r.features, self.engine.device)
                     for r in batch]
            widths = [f.shape[1] for f in feats]
            if len(set(widths)) != 1:   # model zoo fixes the fan-in per model
                raise ValueError(
                    f"micro-batch mixes feature widths {widths}")
            h = feats[0] if k == 1 else torch.cat(feats, dim=1)
            kp = k
            if self.config.pad_to_max_batch and k < self.config.max_batch:
                # single-plan serving: pad the stacked width to max_batch so
                # the engine sees one kernel geometry per graph across all
                # traffic.  The padding REPLICATES the batch's own feature
                # columns (cycling through its requests) rather than
                # zero-filling: zero columns would register as density drift
                # against full batches and thrash the replanner, and would
                # bias the first plan's column densities.  Each request's
                # output block depends only on its own columns, so
                # replication leaves results exact.
                kp = self.config.max_batch
                h = torch.cat([h] + [feats[i % k] for i in range(kp - k)],
                              dim=1)

        saved = (self.engine.drift_threshold, self.engine.sketch_rows)
        compiled = False
        degraded = False
        try:
            self.config.sketch.apply(self.engine)
            breaker_open = self._breaker_open(graph_id)
            if breaker_open:
                # cooldown: pin whatever is compiled, suppress eager replans
                self.engine.drift_threshold = None
            cm_key = (graph_id, tuple(h.shape), str(h.dtype))
            cm = (self._compiled.get(cm_key)
                  if self.config.compile_models else None)
            thr = self.config.sketch.threshold
            drifted = False
            if cm is not None and thr is not None and not breaker_open:
                with span("serving.drift"):
                    drifted = cm.drifted(
                        h, thr, max_rows=self.config.sketch.max_rows,
                        eps=self.engine.eps)
            if drifted:
                if self._breaker_event(graph_id):
                    # churn breaker tripped: serve this (and the cooldown's)
                    # traffic on the last-good program instead of entering
                    # another replan→recompile cycle
                    self.engine.drift_threshold = None
                else:
                    # stale compiled program: the eager re-run below replans
                    # drifted kernels, then a fresh program is compiled
                    self._compiled.pop(cm_key, None)
                    with self._stats_lock:
                        self.stats.compile_invalidations += 1
                    cm = None
            if cm is not None:
                try:
                    logits = cm(h)
                    report = cm.fresh_report()
                    compiled = True
                    if cm.last_activation:
                        with span("serving.activation"):
                            summary = _activation_summary(cm.last_activation)
                        with self._stats_lock:
                            self.stats.record_activation(summary)
                except Exception:
                    # degraded mode: compiled call failed → serve THIS batch
                    # on the eager batched path (program kept — see above)
                    degraded = True
                    self.engine.reset()
                    with span("serving.eager"):
                        logits = gnn.APPLY[self.model](
                            batched_mm(self.engine), adj, h, self.params)
                    report = self.engine.report
            else:
                self.engine.reset()
                if self.config.compile_models:
                    with span("serving.compile"):
                        logits, built = gnn.compile_model(
                            self.model, self.engine, adj, h, self.params,
                            transport=stacked_transport,
                            activation_skip=self.config.activation_skip,
                            activation_slack=self.config.activation_slack,
                            activation_per_stripe=(
                                self.config.activation_per_stripe))
                    if built is not None:
                        self._compiled[cm_key] = built
                        while len(self._compiled) > self.config.max_compiled:
                            self._compiled.pop(next(iter(self._compiled)))
                else:
                    with span("serving.eager"):
                        logits = gnn.APPLY[self.model](
                            batched_mm(self.engine), adj, h, self.params)
                report = self.engine.report
        finally:
            self.engine.drift_threshold, self.engine.sketch_rows = saved
        t1 = time.perf_counter()
        with span("serving.split"):
            out_w = logits.shape[1] // kp
            with self._stats_lock:
                self.stats.batches += 1
                self.stats.compiled_batches += int(compiled)
                self.stats.degraded_batches += int(degraded)
                self.stats.batch_reports.append(report)
            # heartbeat BEFORE resolving any future: serve() returns the
            # moment the last future resolves, and
            # dispatch_stats()["health"] must already show this batch's step
            # by then (racing the worker's epilogue against the caller reads
            # as a missed heartbeat)
            self._monitor.heartbeat("dispatch-0", step_time=t1 - t0)
            share = report.attributed(k)
            for idx, r in enumerate(batch):
                z = logits[:, idx * out_w:(idx + 1) * out_w]
                self._record_request(r, t0=t0, t1=t1, batch_size=k,
                                     report=share)
                self._resolve(r.future, result=z)

    # ------------------------------------------------------ sync interface
    def serve(self, requests: Iterable[tuple[str, object]],
              *, arrival_delay_s: float = 0.0,
              return_exceptions: bool = False) -> list:
        """Blocking convenience: submit ``(graph_id, features)`` pairs as
        concurrent requests, return logits in submission order.  Requests
        submitted in one call coalesce exactly as live traffic would.

        ``return_exceptions=True`` resolves EVERY slot — a failed or
        deadline-expired request yields its exception object in place of
        logits instead of aborting the gather (chaos traffic: no submission
        is ever left unanswered).

        Safe to call with or without a running event loop: plain scripts go
        through ``asyncio.run``; when the calling thread already runs a loop
        (notebooks, async servers), the burst is driven on a dedicated
        thread's fresh loop instead — ``asyncio.run`` would raise
        ``RuntimeError`` there."""
        reqs = list(requests)

        async def _run() -> Sequence[torch.Tensor]:
            tasks = []
            for gid, h in reqs:
                tasks.append(asyncio.ensure_future(self.infer(gid, h)))
                if arrival_delay_s:
                    await asyncio.sleep(arrival_delay_s)
            return await asyncio.gather(*tasks,
                                        return_exceptions=return_exceptions)

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return list(asyncio.run(_run()))
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serving-loop") as pool:
            return list(pool.submit(asyncio.run, _run()).result())
