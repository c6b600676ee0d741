"""PlanCache — amortized Analyzer/Scheduler preprocessing (plan/execute split).

The paper's runtime performs its preprocessing (density measurement, 2-D task
partitioning, Analyzer queue assignment, data-format packing) ONCE per kernel
and then drains the queues on the PL/AIE.  Everything derived from a *static*
operand's sparsity structure is computed once here and reused across layers
and repeated inference calls.

Levels, held in ONE byte-accounted LRU store:

- **structure level** (operand fingerprint + tile geometry): row-stripe
  densities and the packed BlockCSR row-stripes (plus, lazily, the densified
  operand when a plan routes tasks to the dense engine).
- **plan level** (structure key + full kernel geometry + engine mode): the
  task grid, STQ/DTQ assignment, and simulated ``ScheduleReport``.
- **dispatch level** (structure key + plan digest): the plan lowered into a
  device-resident :class:`~repro_torch.core.dispatch.CompiledDispatch`.
- **sharded-dispatch level** (structure key + plan digest + device count
  + operand-sharding mode): a mesh engine's placed plan lowered into a
  :class:`~repro_torch.core.shard_exec.ShardedDispatch`.
- **activation-dispatch level** (plan digest + capacity + eps): the
  capacity-parameterized descriptor arrays of an activation-side (dense X)
  kernel's block-skip route
  (:class:`~repro_torch.core.dispatch.ActivationDispatch`) — content
  independent, so one lowering serves every activation of that shape.
- **calibration level** (device kind + block + dtype + base model): measured
  performance models (:class:`~repro_torch.core.calibrate.CalibratedModel`),
  so a ``SharedPlanCache`` snapshot replays a restart with zero
  measurements.

Only kernels whose X operand is ``SparseCOO`` are planned once; dense X
(activations) is planned fresh every call.  Keys and fingerprints equal the
reference package's for the same operand, so the two caches can be compared
entry by entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.partition import KernelPartition, Task
from repro_torch.core.primitives import SparseCOO
from repro_torch.core.scheduler import ScheduleReport
from repro_torch.device import host
from repro_torch.kernels.formats import BlockCSR


def coo_fingerprint(x: SparseCOO) -> str:
    """Content digest of a COO matrix: the raw bytes of the int32 rows/cols
    and float32 vals (the same bytes the reference hashes, so the digests
    are equal), plus shape and tag.  Values are included: the cached packed
    blocks carry them.

    Memoized on the instance, tagged with the component tensors' identities
    so reassigning ``x.rows``/``x.cols``/``x.vals`` invalidates it (the
    tensors are never mutated in place by the port)."""
    arr_ids = (id(x.rows), id(x.cols), id(x.vals))
    memo = getattr(x, "_plan_fp", None)
    if memo is not None and memo[0] == arr_ids:
        return memo[1]
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(host(x.rows)).tobytes())
    h.update(np.ascontiguousarray(host(x.cols)).tobytes())
    h.update(np.ascontiguousarray(host(x.vals)).tobytes())
    h.update(repr((tuple(x.shape), x.tag)).encode())
    fp = h.hexdigest()
    x._plan_fp = (arr_ids, fp)
    return fp


def key_mentions(key, fingerprint: str) -> bool:
    """True when ``fingerprint`` appears anywhere in a (nested) cache key.
    Every key that depends on an operand's content embeds its fingerprint
    digest verbatim, so a recursive scan finds all of a graph's entries
    without knowing each level's key layout."""
    if isinstance(key, tuple):
        return any(key_mentions(k, fingerprint) for k in key)
    return key == fingerprint


def nbytes_of(obj) -> int:
    """Deep byte size of a cache entry's array payload.

    Counts ndarray/torch buffers exactly (``.nbytes``) and charges a small flat
    constant per scalar/str/None so task lists are not free; containers and
    dataclasses are traversed recursively.  Python-object overhead is
    deliberately ignored — the arrays (packed blocks, densified operands,
    density vectors) dominate every real entry.
    """
    if obj is None:
        return 8
    if isinstance(obj, (bool, int, float, complex)):
        return 8
    if isinstance(obj, (str, bytes)):
        return len(obj)
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    nb = getattr(obj, "nbytes", None)
    if isinstance(nb, (int, np.integer)):       # torch.Tensor and friends
        return int(nb)
    if isinstance(obj, dict):
        return sum(nbytes_of(k) + nbytes_of(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(nbytes_of(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(nbytes_of(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 64  # unknown opaque object: flat charge


@dataclasses.dataclass
class CacheStats:
    plan_hits: int = 0
    plan_misses: int = 0
    struct_hits: int = 0
    struct_misses: int = 0
    packs: int = 0       # structure packing events (BlockCSR stripes)
    analyzes: int = 0    # structure density analyses
    replans: int = 0     # density-drift revalidations that re-planned
    evictions: int = 0   # entries dropped by LRU (bytes or count bound)
    bytes_evicted: int = 0
    invalidations: int = 0  # entries purged as stale (superseded graph)
    # compiled-dispatch level (the steady-state serving path): a build lowers
    # a plan into descriptor arrays ONCE; every later request is a hit with
    # zero host descriptor work.
    dispatch_builds: int = 0    # plan -> CompiledDispatch lowerings
    dispatch_hits: int = 0      # requests served from a cached dispatch
    trace_builds: int = 0       # first executor call per signature
    trace_cache_hits: int = 0   # executor calls on a signature seen before
    # activation-dispatch level: descriptor lowerings of the block-skip
    # route, and reuses of a cached one (compiled replays credit these too)
    act_builds: int = 0
    act_hits: int = 0
    # calibration level: measured models built (swept or read from a
    # snapshot file) and reused; unusable snapshots (cold starts)
    calib_builds: int = 0
    calib_hits: int = 0
    snapshot_errors: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def hit_rate(self) -> float:
        total = self.plan_hits + self.plan_misses
        return self.plan_hits / total if total else 0.0


@dataclasses.dataclass
class KernelPlan:
    """Everything ``DynasparseEngine.execute`` needs, decoupled from planning.

    ``struct_key`` is set when the X operand is cacheable (static sparsity);
    it addresses the packed-stripe entry used by the literal dispatch path.
    ``placement`` is set by mesh engines (``analyze_sharded``): the
    contiguous row-stripe band each device owns; ``None`` on single-device
    plans.
    """
    part: KernelPartition
    stq: list[Task]
    dtq: list[Task]
    report: ScheduleReport
    row_density: np.ndarray
    col_density: np.ndarray
    struct_key: tuple | None = None
    placement: object | None = None   # core.partition.DevicePlacement


@dataclasses.dataclass
class StructureEntry:
    """Packed form of a static operand at one (tile_m, block, eps) geometry.

    ``dense`` is lazy: stripes are packed straight from the COO triplets
    (no dense intermediate — required beyond toy scale), and the densified
    operand is only materialized if a plan actually routes tasks of this
    operand to the dense engine (or the per-task path needs it)."""
    stripes: dict[int, BlockCSR]      # row-stripe index -> packed BlockCSR
    dense: object | None = None       # densified operand, device-resident


class PlanCache:
    """Structure-keyed, byte-accounted LRU cache of kernel plans and packed
    operands.

    ``capacity`` bounds the entry count (backstop); ``max_bytes`` bounds the
    summed deep array payload across ALL entry kinds — plans, density
    vectors and packed structures share one LRU order, so a cold graph's
    packed stripes are evicted before a hot graph's plans.
    """

    # entry-kind prefixes of the unified store
    _PLAN, _DENSITY, _STRUCT, _DISPATCH = "plan", "density", "struct", "dispatch"
    _ACT = "actdispatch"
    _SHARD = "sharddispatch"
    _CALIB = "calib"

    def __init__(self, capacity: int = 256, max_bytes: int | None = None):
        self.capacity = capacity
        self.max_bytes = max_bytes
        self._entries: OrderedDict[tuple, tuple[object, int]] = OrderedDict()
        self.bytes_used = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------- helpers
    def _get(self, kind: str, key):
        k = (kind, key)
        if k in self._entries:
            self._entries.move_to_end(k)
            return self._entries[k][0]
        return None

    def _put(self, kind: str, key, value) -> None:
        k = (kind, key)
        nb = nbytes_of(value)
        if k in self._entries:
            self.bytes_used -= self._entries[k][1]
        self._entries[k] = (value, nb)
        self._entries.move_to_end(k)
        self.bytes_used += nb
        self._evict()

    def _evict(self) -> None:
        while len(self._entries) > self.capacity or (
                self.max_bytes is not None
                and self.bytes_used > self.max_bytes
                and len(self._entries) > 1):
            _, (_, nb) = self._entries.popitem(last=False)
            self.bytes_used -= nb
            self.stats.evictions += 1
            self.stats.bytes_evicted += nb

    def purge_fingerprint(self, fingerprint: str) -> int:
        """Drop every entry whose key embeds ``fingerprint`` (all levels).
        The invalidation hook for content no longer reachable — a graph id
        re-registered with different adjacency content — so a later
        ``save`` cannot persist (and a ``load`` cannot resurrect) its stale
        compiled artifacts.  Returns the number of entries purged."""
        doomed = [k for k in self._entries
                  if key_mentions(k[1], fingerprint)]
        for k in doomed:
            _, nb = self._entries.pop(k)
            self.bytes_used -= nb
            self.stats.invalidations += 1
        return len(doomed)

    def recharge(self, kind: str, key) -> None:
        """Re-measure an entry whose payload mutated in place (e.g. a
        ``StructureEntry`` whose lazy ``dense`` was just materialized)."""
        k = (kind, key)
        if k in self._entries:
            value, nb = self._entries[k]
            self.bytes_used -= nb
            new_nb = nbytes_of(value)
            self._entries[k] = (value, new_nb)
            self.bytes_used += new_nb
            self._evict()

    def __len__(self) -> int:
        return len(self._entries)

    def plan_count(self) -> int:
        """Number of cached plan-level entries.  The serving layer's
        single-plan gate: with ``pad_to_max_batch`` every registered graph
        contributes exactly one plan per distinct kernel geometry,
        regardless of traffic shape."""
        return sum(1 for (kind, _key) in self._entries if kind == self._PLAN)

    def items(self) -> Iterator[tuple[tuple, object]]:
        """(kind, key) -> value pairs in LRU order (persistence hook)."""
        for (kind, key), (value, _) in self._entries.items():
            yield (kind, key), value

    # ---------------------------------------------------------- plan level
    def get_plan(self, key: tuple) -> KernelPlan | None:
        plan = self._get(self._PLAN, key)
        if plan is None:
            self.stats.plan_misses += 1
        else:
            self.stats.plan_hits += 1
        return plan

    def put_plan(self, key: tuple, plan: KernelPlan) -> None:
        self._put(self._PLAN, key, plan)

    # ----------------------------------------------------- structure level
    def row_density(self, key: tuple,
                    compute: Callable[[], np.ndarray]) -> np.ndarray:
        """Get-or-compute the per-row-stripe densities of a static operand."""
        d = self._get(self._DENSITY, key)
        if d is not None:
            self.stats.struct_hits += 1
            return d
        self.stats.struct_misses += 1
        self.stats.analyzes += 1
        d = np.asarray(compute())
        self._put(self._DENSITY, key, d)
        return d

    def structure(self, key: tuple,
                  compute: Callable[[], StructureEntry]) -> StructureEntry:
        """Get-or-compute the packed BlockCSR-stripe form."""
        e = self._get(self._STRUCT, key)
        if e is not None:
            self.stats.struct_hits += 1
            return e
        self.stats.struct_misses += 1
        self.stats.packs += 1
        e = compute()
        self._put(self._STRUCT, key, e)
        return e

    # ------------------------------------------------------ dispatch level
    def dispatch(self, key: tuple, compute: Callable[[], object]):
        """Get-or-compute a :class:`~repro_torch.core.dispatch.CompiledDispatch`.

        Keyed on (structure key, plan digest): a replan that lands on the
        same task assignment reuses the lowered descriptors; a changed
        assignment misses to a fresh build.  ``compute`` may return ``None``
        (unlowerable geometry) — never cached, so the caller's fallback
        decision is re-evaluated per plan, not remembered forever."""
        d = self._get(self._DISPATCH, key)
        if d is not None:
            self.stats.dispatch_hits += 1
            return d
        d = compute()
        if d is not None:
            self.stats.dispatch_builds += 1
            self._put(self._DISPATCH, key, d)
        return d

    def dispatch_count(self) -> int:
        """Number of cached compiled-dispatch entries (steady state:
        ``dispatch_builds == plan_count()``)."""
        return sum(1 for (kind, _k) in self._entries
                   if kind == self._DISPATCH)

    def sharded_dispatch(self, key: tuple, compute: Callable[[], object]):
        """Get-or-compute a
        :class:`~repro_torch.core.shard_exec.ShardedDispatch`.

        Keyed on (structure key, plan digest, device count, operand-sharding
        mode): the digest of a placed plan hashes the band layout and the
        ownership split, the device count keeps sharded entries apart from
        unsharded ones, and the mode keeps halo and replicated lowerings of
        one plan apart.  Counts into the shared ``dispatch_*`` counters, so
        ``dispatch_builds == plans`` holds in steady state whether an engine
        shards or not.  ``None`` is never cached."""
        d = self._get(self._SHARD, key)
        if d is not None:
            self.stats.dispatch_hits += 1
            return d
        d = compute()
        if d is not None:
            self.stats.dispatch_builds += 1
            self._put(self._SHARD, key, d)
        return d

    def sharded_count(self) -> int:
        """Number of cached sharded-dispatch entries."""
        return sum(1 for (kind, _k) in self._entries if kind == self._SHARD)

    def sharded_operand_bytes(self) -> dict:
        """Analytic dense-operand memory over every cached sharded
        dispatch: owned / halo / replicated-fallback bytes
        (``ShardedDispatch.operand_bytes``) summed across entries, plus the
        replicated baseline those entries would have cost.  Surfaced by
        ``ServingEngine.dispatch_stats()``."""
        out = {"entries": 0, "owned_bytes": 0, "halo_bytes": 0,
               "fallback_bytes": 0, "replicated_bytes": 0}
        for (kind, _k), (value, _nb) in list(self._entries.items()):
            if kind != self._SHARD:
                continue
            ob = getattr(value, "operand_bytes", None)
            if not ob:
                continue
            out["entries"] += 1
            for f in ("owned_bytes", "halo_bytes", "fallback_bytes"):
                out[f] += int(ob.get(f, 0))
            out["replicated_bytes"] += (
                int(ob.get("replicated_per_device_bytes", 0))
                * int(getattr(value, "n_devices", 1)))
        return out

    # ------------------------------------------- activation-dispatch level
    def activation_dispatch(self, key: tuple, compute: Callable[[], object]):
        """Get-or-compute an
        :class:`~repro_torch.core.dispatch.ActivationDispatch`.  Keyed on
        (plan digest, capacity, eps) — content-independent by construction,
        so activation kernels of different requests (and different layers
        with one geometry/assignment) share one descriptor lowering.
        ``None`` (unlowerable geometry) is never cached."""
        d = self._get(self._ACT, key)
        if d is not None:
            self.stats.act_hits += 1
            return d
        d = compute()
        if d is not None:
            self.stats.act_builds += 1
            self._put(self._ACT, key, d)
        return d

    def activation_count(self) -> int:
        """Number of cached activation-dispatch entries."""
        return sum(1 for (kind, _k) in self._entries if kind == self._ACT)

    # --------------------------------------------------- calibration level
    def calibration(self, key: tuple, compute: Callable[[], object]):
        """Get-or-compute a measured performance model
        (:class:`repro_torch.core.calibrate.CalibratedModel`), keyed on
        (device kind, block, dtype, base model).  ``None`` is never
        cached."""
        m = self._get(self._CALIB, key)
        if m is not None:
            self.stats.calib_hits += 1
            return m
        m = compute()
        if m is not None:
            self.stats.calib_builds += 1
            self._put(self._CALIB, key, m)
        return m

    def calibration_count(self) -> int:
        """Number of cached calibration entries."""
        return sum(1 for (kind, _k) in self._entries if kind == self._CALIB)

    def clear(self) -> None:
        self._entries.clear()
        self.bytes_used = 0
        self.stats = CacheStats()
