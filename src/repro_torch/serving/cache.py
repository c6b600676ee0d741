"""SharedPlanCache — the process-wide, multi-graph, persistent plan cache.

Serving amortizes the paper's preprocessing across *every* request the
process handles, not just requests of one engine: all ``ServingEngine``
instances (and any ``DynasparseEngine`` constructed with it) share one
byte-accounted LRU store, so two models serving the same graph share one
packed adjacency, and a cold graph's packed stripes are evicted before a hot
graph's plans.

Keying: graphs are registered under a :class:`GraphKey` —
``(fingerprint, shape, dtype)`` — where the fingerprint is the O(nnz) content
digest also used by the plan-level keys, so a registry entry and its cache
entries can never disagree about which adjacency they describe.

Persistence: ``save()`` snapshots every cache entry (tensors are pulled back
to host numpy) plus the graph registry in the port's own format
(``"repro_torch.plancache"``); ``load()`` restores it through the restricted
reader of :mod:`repro_torch.snapshot` and re-uploads packed structures and
dispatch arrays to the cache's device once, so a serving restart skips
re-analysis, re-packing and re-lowering entirely.  A snapshot of the JAX
package is refused (a logged cold start), and a sharded dispatch of a mesh
larger than the devices this host shows is skipped (``mesh_skipped``).
"""
from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np
import torch

from repro_torch import snapshot
from repro_torch.core.plancache import (PlanCache, StructureEntry,
                                        coo_fingerprint, key_mentions)
from repro_torch.core.primitives import SparseCOO
from repro_torch.device import host, resolve_device
from repro_torch.launch.mesh import visible_devices

logger = logging.getLogger(__name__)

_PERSIST_FORMAT = "repro_torch.plancache"
# v2: mesh-sharded dispatch — KernelPlan carries a DevicePlacement and the
# sharded-dispatch entry kind (ShardedDispatch, its ColumnSupports and
# HaloGeometry) was added; v1 snapshots cold-start.
_PERSIST_VERSION = 2


@dataclasses.dataclass(frozen=True)
class GraphKey:
    """Identity of a registered graph: content fingerprint + geometry."""
    fingerprint: str
    shape: tuple[int, int]
    dtype: str

    @classmethod
    def of(cls, adj: SparseCOO) -> "GraphKey":
        return cls(fingerprint=coo_fingerprint(adj),
                   shape=tuple(adj.shape),
                   dtype=str(host(adj.vals).dtype))


def _to_host(obj):
    """Recursively pull tensors back to host numpy (pickle-safe)."""
    if isinstance(obj, torch.Tensor):
        return host(obj)
    if isinstance(obj, np.ndarray) or obj is None or isinstance(
            obj, (bool, int, float, complex, str, bytes)):
        return obj
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_host(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _to_device(obj, dev: torch.device):
    """Recursively upload the numpy arrays of a restored structure or
    dispatch entry to ``dev`` (the inverse of :func:`_to_host` for entries
    whose arrays all live on the device)."""
    if isinstance(obj, np.ndarray):
        return torch.as_tensor(obj, device=dev)
    if isinstance(obj, dict):
        return {k: _to_device(v, dev) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    return obj


class SharedPlanCache(PlanCache):
    """Thread-safe multi-graph :class:`PlanCache` with save/load.

    Defaults are serving-scale: room for many graphs' plans under one byte
    budget.  All mutating/reading accessors take an RLock so engines on
    worker threads can share one instance.  ``device`` is where restored
    entries are uploaded (``"cuda"`` by default, through
    :func:`repro_torch.device.resolve_device`); a ``ServingEngine`` refuses
    an engine on another device.
    """

    def __init__(self, capacity: int = 4096,
                 max_bytes: int | None = 256 * 1024 * 1024,
                 faults: object = None, device="cuda"):
        super().__init__(capacity=capacity, max_bytes=max_bytes)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._graphs: dict[str, GraphKey] = {}   # graph_id -> key
        # optional repro_torch.serving.faults.FaultInjector probed at the
        # snapshot_save / snapshot_load sites; assignable after construction
        self.faults = faults

    # ----------------------------------------------------- locked accessors
    # The get-or-compute methods are locked as a WHOLE (not just the
    # primitive _get/_put) so two worker threads can never pack/analyze the
    # same structure twice or interleave a replace between a miss and its
    # put — the RLock makes the nested primitive locking reentrant.
    def _get(self, kind, key):
        with self._lock:
            return super()._get(kind, key)

    def _put(self, kind, key, value):
        with self._lock:
            super()._put(kind, key, value)

    def recharge(self, kind, key):
        with self._lock:
            super().recharge(kind, key)

    def get_plan(self, key):
        with self._lock:
            return super().get_plan(key)

    def put_plan(self, key, plan):
        with self._lock:
            super().put_plan(key, plan)

    def row_density(self, key, compute):
        with self._lock:
            return super().row_density(key, compute)

    def structure(self, key, compute):
        with self._lock:
            return super().structure(key, compute)

    def dispatch(self, key, compute):
        with self._lock:
            return super().dispatch(key, compute)

    def sharded_dispatch(self, key, compute):
        with self._lock:
            return super().sharded_dispatch(key, compute)

    def sharded_count(self):
        with self._lock:
            return super().sharded_count()

    def dispatch_count(self):
        with self._lock:
            return super().dispatch_count()

    def activation_dispatch(self, key, compute):
        with self._lock:
            return super().activation_dispatch(key, compute)

    def activation_count(self):
        with self._lock:
            return super().activation_count()

    def calibration(self, key, compute):
        with self._lock:
            return super().calibration(key, compute)

    def calibration_count(self):
        with self._lock:
            return super().calibration_count()

    def purge_fingerprint(self, fingerprint):
        with self._lock:
            return super().purge_fingerprint(fingerprint)

    def items(self):
        with self._lock:
            yield from list(super().items())

    def plan_count(self):
        with self._lock:
            return super().plan_count()

    def clear(self):
        with self._lock:
            super().clear()
            self._graphs.clear()

    # ------------------------------------------------------- graph registry
    def register_graph(self, graph_id: str, adj: SparseCOO) -> GraphKey:
        """Register (or re-register) a graph under ``graph_id``.

        Re-registering the same id with DIFFERENT content purges the old
        content's cache entries — plans, packed structures and compiled
        dispatches — unless another registered id still maps to that
        content, so a later ``save`` cannot persist them and a ``load``
        cannot resurrect them.
        """
        key = GraphKey.of(adj)
        with self._lock:
            old = self._graphs.get(graph_id)
            self._graphs[graph_id] = key
            if (old is not None and old.fingerprint != key.fingerprint
                    and not any(k.fingerprint == old.fingerprint
                                for k in self._graphs.values())):
                self.purge_fingerprint(old.fingerprint)
        return key

    def graph_key(self, graph_id: str) -> GraphKey | None:
        with self._lock:
            return self._graphs.get(graph_id)

    @property
    def graphs(self) -> dict[str, GraphKey]:
        with self._lock:
            return dict(self._graphs)

    # --------------------------------------------------------- persistence
    def save(self, path: str) -> dict:
        """Snapshot every entry + the graph registry to ``path``.

        Tensors are converted to host numpy; entry order (LRU) is
        preserved.  Returns a small manifest (entry count, bytes) for logs.
        The write is ATOMIC (a temp file moved into place), so a crash
        mid-save leaves the previous snapshot intact.
        """
        with self._lock:
            entries = [((kind, key), _to_host(value))
                       for (kind, key), value in self.items()]
            payload = {
                "format": _PERSIST_FORMAT,
                "version": _PERSIST_VERSION,
                "entries": entries,
                "graphs": dict(self._graphs),
            }
            manifest = {"entries": len(entries), "bytes": self.bytes_used,
                        "graphs": len(self._graphs)}
        probe = None
        if self.faults is not None:
            probe = lambda: self.faults.probe("snapshot_save", detail=path)
        snapshot.atomic_dump(path, payload, before_dump=probe)
        return manifest

    def load(self, path: str) -> dict:
        """Restore a snapshot saved by :meth:`save` into this cache.

        Loaded entries land in saved LRU order *below* anything already
        cached; structures and dispatch arrays are uploaded to the cache's
        device once, here.  Stats are not restored, except that
        ``snapshot_errors`` counts against THIS process.

        An unusable snapshot — missing, truncated, corrupt, a foreign
        pickle (a JAX package snapshot among them), or another format or
        version — degrades to a logged COLD START: the cache is left as it
        was, ``snapshot_errors`` is incremented, and the manifest carries
        the reason under ``"error"`` with ``cold_start=True``.

        Live registrations win over the snapshot: a graph id already
        registered in THIS process keeps its mapping, and snapshot entries
        whose content key belongs to an id the live registry has since
        re-bound to different content are SKIPPED.
        """
        try:
            if self.faults is not None:
                self.faults.probe("snapshot_load", detail=path)
            with open(path, "rb") as f:
                payload = snapshot.load(f)
            if not isinstance(payload, dict):
                raise ValueError(
                    f"plan-cache snapshot payload is "
                    f"{type(payload).__name__}, not a dict")
            if payload.get("format") != _PERSIST_FORMAT:
                raise ValueError(
                    f"not a {_PERSIST_FORMAT} snapshot (format "
                    f"{payload.get('format')!r})")
            if payload.get("version") != _PERSIST_VERSION:
                raise ValueError(
                    f"unsupported plan-cache snapshot version "
                    f"{payload.get('version')!r} (want {_PERSIST_VERSION})")
            snap_graphs: dict[str, GraphKey] = payload["graphs"]
            snap_entries = list(payload["entries"])
        except Exception as exc:
            with self._lock:
                self.stats.snapshot_errors += 1
            logger.warning(
                "plan-cache snapshot %s unusable (%s: %s) — cold start",
                path, type(exc).__name__, exc)
            return {"entries": 0, "stale_skipped": 0, "mesh_skipped": 0,
                    "graphs": 0, "cold_start": True,
                    "error": f"{type(exc).__name__}: {exc}"}
        with self._lock:
            # fingerprints the live registry has superseded — unless some
            # current (or non-conflicting snapshot) id still maps to them
            stale = {key.fingerprint for gid, key in snap_graphs.items()
                     if gid in self._graphs
                     and self._graphs[gid].fingerprint != key.fingerprint}
            stale -= {k.fingerprint for k in self._graphs.values()}
            stale -= {key.fingerprint for gid, key in snap_graphs.items()
                      if gid not in self._graphs}

            live = list(self.items())
            self._entries.clear()
            self.bytes_used = 0
            n_live = visible_devices(self.device.type)
            loaded = skipped = mesh_skipped = 0
            for (kind, key), value in snap_entries:
                if any(key_mentions(key, fp) for fp in stale):
                    skipped += 1
                    continue
                if kind == self._SHARD and value.n_devices > n_live:
                    # a sharded dispatch of a bigger mesh than this host can
                    # build: its keys carry the device count, so it could
                    # never be hit — not resurrected into the byte budget
                    mesh_skipped += 1
                    continue
                if kind in (self._STRUCT, self._DISPATCH, self._ACT,
                            self._SHARD):
                    value = _to_device(value, self.device)
                super()._put(kind, key, value)
                loaded += 1
            for (kind, key), value in live:
                super()._put(kind, key, value)
            for gid, key in snap_graphs.items():
                self._graphs.setdefault(gid, key)
            return {"entries": loaded, "stale_skipped": skipped,
                    "mesh_skipped": mesh_skipped,
                    "graphs": len(snap_graphs), "cold_start": False}


# --------------------------------------------------------------- singleton
_shared: SharedPlanCache | None = None
_shared_lock = threading.Lock()


def get_shared_cache() -> SharedPlanCache:
    """The process-wide cache used by every ServingEngine by default (on
    the card: ``SharedPlanCache()``'s default device)."""
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = SharedPlanCache()
        return _shared


def set_shared_cache(cache: SharedPlanCache | None) -> None:
    """Swap (or reset, with ``None``) the process-wide cache — tests and
    programs that need an isolated or pre-loaded instance."""
    global _shared
    with _shared_lock:
        _shared = cache
