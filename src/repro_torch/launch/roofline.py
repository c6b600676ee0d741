"""Roofline terms and step costs of the port's LM steps: the counterpart of
the reference's ``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh) cell, all in seconds, per device:
    compute    = FLOPs / peak FLOP/s
    memory     = bytes / HBM bandwidth
    collective = collective bytes / link bandwidth

Hardware constants: one NVIDIA H100 SXM5 80GB, NVIDIA's data sheet
(dense rates at the 700 W limit): 989 TFLOP/s bfloat16 on the tensor
cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s in each direction per GPU.

The reference compiles each step with XLA and reads its cost analysis and
optimized HLO text.  The port has neither: :func:`step_cost` runs the
step itself, eagerly, on ``meta`` tensors (shapes and dtypes without
memory), and counts every aten op as it runs (:class:`StepCounter`).  One
eager op is one kernel, so the counts are those of the program the card
runs:

- *FLOPs*: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``), which count matrix products only (mm, bmm, addmm,
  baddbmm, convolution, attention), as ``hlo_cost`` counts only dots;
- *bytes*: every op that is not a view reads its tensor inputs and writes
  its outputs, with the reference's HBM-traffic cases: a gather or
  indexing op counts twice its output; an in-place update of a slice
  (``copy_``, ``index_put_``, ``index_copy_``, ``index_add_``) twice the
  update; a fill (``fill_``, ``zero_``, ``full``, ``zeros``, ``ones``,
  their ``_like`` / ``new_`` forms, ``arange``) its output only; an
  allocation (``empty`` and its forms) nothing; a view (its outputs on
  its inputs' storage) nothing;
- *peak_bytes*: the largest sum of live storages while the step runs:
  those held on entry (the arguments', and any storage the step reads
  that existed before it), what it allocates, and what autograd saves
  for the backward until it is freed.

No counterpart, and why: ``_parse_computations`` and ``_trip_count`` (a
port step is Python run op by op, so no loop body is counted once for
many trips; a repeated microbatch is counted once and scaled by
``launch/dryrun.py``); ``collective_bytes`` of HLO text
(:func:`step_collectives` counts the port's own transfers from the
sharding rules); ``convert_traffic`` (the float32 converts XLA's CPU
backend puts around bfloat16 dots; the port's casts are ops it runs and
are counted as any op); ``lowered_cost`` (there is no compile step).
"""
from __future__ import annotations

import collections
import math
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import Sharded

PEAK_FLOPS = 989e12          # bfloat16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # NVLink 4 bytes/s per direction per card

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the reference's HBM-traffic cases, by aten op name
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take"})
# in-place slice updates: the argument that holds the update
_UPDATES = {"copy_": 1, "index_put_": 2, "_index_put_impl_": 2,
            "index_copy_": 3, "index_add_": 3}
_FILLS = frozenset({"fill_", "zero_", "full", "zeros", "ones", "full_like",
                    "zeros_like", "ones_like", "new_full", "new_zeros",
                    "new_ones", "arange", "scalar_tensor", "linspace"})
_ALLOCS = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def op_bytes(func, args, ins, outs) -> int:
    """The HBM bytes of one aten op (module docstring): ``ins`` / ``outs``
    its tensor inputs and outputs."""
    name = func.overloadpacket.__name__
    if name in _ALLOCS:
        return 0
    if name in _FILLS:
        return sum(map(_nbytes, outs))
    if name in _UPDATES:
        return 2 * _nbytes(args[_UPDATES[name]])
    if not func._schema.is_mutable:
        in_keys = {_key(t) for t in ins}
        if outs and all(_key(t) in in_keys for t in outs):
            return 0                                  # a view
    if name in _GATHERS:
        return 2 * sum(map(_nbytes, outs))
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and peak live bytes of whatever runs inside it
    (``with StepCounter(held) as c: ...``).  ``held``: tensors whose
    storages count as live on entry (each storage once).  ``totals()`` may
    be read inside, to cut a run into sections.

    FLOPs use the formulas of ``FlopCounterMode``'s registry
    (``torch.utils.flop_counter.flop_registry``), op by op; the mode
    itself is not entered, because its module tracker holds tensors until
    it exits, which would raise the peak.

    A storage is keyed by its ``StorageImpl`` address, pinned by a
    ``StorageWeakRef`` for as long as it is tracked (so no other storage
    can take the address).  A storage made inside the counter is live
    while a tensor the counter saw come out of an op holds it; when the
    last of those dies, it becomes an orphan (autograd may still hold it
    for the backward), and orphans whose storage has expired are dropped
    before any new high mark is taken."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = self.bytes = 0
        self.top = collections.Counter()
        self.calls = collections.Counter()
        self.size: dict[int, int] = {}
        self.refs: dict[int, StorageWeakRef] = {}
        self.count: dict[int, int] = {}
        self.orphans: dict[int, None] = {}
        self.held: set[int] = set()
        self.tracked: dict[int, weakref.ref] = {}
        self.live = self.peak = 0
        for t in held:
            self._hold(t)
        self.held_bytes = self.live

    def _hold(self, t: torch.Tensor) -> None:
        k = _key(t)
        if k not in self.size:
            st = t.untyped_storage()
            self.size[k], self.refs[k] = st.nbytes(), StorageWeakRef(st)
            self.held.add(k)
            self.live += self.size[k]
            self.peak = max(self.peak, self.live)

    def _dead(self, k: int, i: int) -> None:
        del self.tracked[i]
        self.count[k] -= 1
        if not self.count[k]:
            del self.count[k]
            self.orphans[k] = None

    def sweep(self) -> None:
        """Drop the orphans whose storage has been freed."""
        for k in [k for k in self.orphans if self.refs[k].expired()]:
            del self.orphans[k]
            self.live -= self.size.pop(k)
            del self.refs[k]

    def _track(self, t: torch.Tensor) -> None:
        ref = self.tracked.get(id(t))
        if ref is not None and ref() is t:
            return                               # an in-place op's self
        k = _key(t)
        if k in self.held:
            return
        if k not in self.size:
            st = t.untyped_storage()
            self.size[k], self.refs[k] = st.nbytes(), StorageWeakRef(st)
            self.live += self.size[k]
            if self.live > self.peak:
                self.sweep()
                self.peak = max(self.peak, self.live)
        self.orphans.pop(k, None)
        self.count[k] = self.count.get(k, 0) + 1
        self.tracked[id(t)] = weakref.ref(t, lambda _, k=k, i=id(t):
                                          self._dead(k, i))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            if _key(t) not in self.size:
                self._hold(t)       # memory that existed before the step
        out = func(*args, **kwargs)
        flops = flop_registry.get(func.overloadpacket)
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        b = op_bytes(func, args, ins, outs)
        if b:
            self.bytes += b
            shape = tuple(outs[0].shape) if outs else ()
            dtype = str(outs[0].dtype).removeprefix("torch.") if outs else ""
            label = f"{func.overloadpacket.__name__} {shape} {dtype}"
            self.top[label] += b
            self.calls[label] += 1
        for t in outs:
            self._track(t)
        return out

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.sweep()

    def totals(self) -> tuple[int, int]:
        """(FLOPs, bytes) counted so far."""
        return self.flops, self.bytes

    def result(self) -> dict:
        """``{"flops", "bytes", "peak_bytes", "held_bytes",
        "collectives"}``; collectives are not ops of a port step (one
        controller drives every device: :func:`step_collectives` counts
        them), so all five are 0 here."""
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak, "held_bytes": self.held_bytes,
                "collectives": dict.fromkeys(COLLECTIVES, 0)}

    def top_bytes(self, n: int = 15) -> list[tuple[int, str]]:
        """The ``n`` op kinds (aten name, output shape and dtype) with the
        most bytes: ``(bytes, "x<calls> <name> <shape> <dtype>")``."""
        return [(v, f"x{self.calls[k]} {k}")
                for k, v in self.top.most_common(n)]


def held_tensors(*trees) -> list[torch.Tensor]:
    """Every tensor of nested dicts / lists / tuples, ``Sharded`` leaves
    (their blocks) and modules (their parameters, buffers and compute
    copies)."""
    out = []
    for tree in trees:
        if isinstance(tree, torch.Tensor):
            out.append(tree)
        elif isinstance(tree, Sharded):
            out += list(tree.tensors.values())
        elif isinstance(tree, torch.nn.Module):
            out += list(tree.parameters()) + list(tree.buffers())
            for m in tree.modules():
                out += list(getattr(m, "_compute", {}).values())
        elif isinstance(tree, dict):
            out += held_tensors(*tree.values())
        elif isinstance(tree, (list, tuple)):
            out += held_tensors(*tree)
    return out


def step_cost(fn, *args) -> dict:
    """Run ``fn(*args)`` (on meta tensors: the counts need no memory) and
    count it: :meth:`StepCounter.result`, with ``args`` held on entry."""
    with StepCounter(held_tensors(args)) as c:
        fn(*args)
    return c.result()


def top_bytes(fn, *args, n: int = 15) -> list[tuple[int, str]]:
    """The counterpart of the reference's ``hlo_top_bytes``: the ``n`` op
    kinds of ``fn(*args)`` with the most bytes."""
    with StepCounter(held_tensors(args)) as c:
        fn(*args)
    return c.top_bytes(n)


def step_collectives(mesh, state: dict) -> dict[str, int]:
    """The bytes of the port's own transfers for one device in one step
    (every device's blocks are alike), by the reference's five kinds,
    each as the size of its result on that device (the reference sums
    result shapes of per-device HLO):

    - ``all-gather``: every parameter leaf that is not one whole block on
      the device, gathered whole into its replica (``MeshCompute.bind``),
      and for a decode step every cache leaf of its rows split over an
      axis other than the batch's, gathered to its whole length;
    - ``reduce-scatter`` (training, ``"opt"`` in ``state``): the device's
      block of each gradient that is sharded, reduced over the replicas
      in rank order and sent to its owners;
    - ``all-reduce`` (training): each gradient of a leaf held whole on
      every device;
    - ``all-to-all`` and ``collective-permute``: 0 (the port has none).

    ``state``: ``{"params": {name: Sharded}}``, plus ``"opt"`` for a
    training state and ``"cache"`` (``{path: Sharded}`` of the full
    batch) for a decode step.  On a one-device mesh nothing moves."""
    out = dict.fromkeys(COLLECTIVES, 0)
    if mesh.size == 1:
        return out
    train = "opt" in state
    for leaf in state["params"].values():
        item = leaf.dtype.itemsize
        whole = math.prod(leaf.shape) * item
        if leaf.block_shape != leaf.shape:
            out["all-gather"] += whole
            if train:
                out["reduce-scatter"] += math.prod(leaf.block_shape) * item
        elif train:
            out["all-reduce"] += whole
    for leaf in state.get("cache", {}).values():
        rows = rows_shape(leaf)
        if rows != leaf.block_shape:
            out["all-gather"] += math.prod(rows) * leaf.dtype.itemsize
    return out


def _axes(entry) -> set:
    return set((entry,) if isinstance(entry, str) else entry or ())


def rows_shape(leaf) -> tuple[int, ...]:
    """The shape of a cache leaf (a ``Sharded`` of the full batch) on one
    device once its splits over axes other than the batch axes ("pod",
    "data") are gathered: the device's rows at their whole length."""
    return tuple(b if _axes(e) <= {"pod", "data"} else d
                 for b, d, e in zip(leaf.block_shape, leaf.shape, leaf.spec))


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, n_chips: int) -> dict:
    """All inputs are PER DEVICE (the busiest device's step).  ``n_chips``
    is kept for reporting."""
    t_compute = flops_per_chip / PEAK_FLOPS
    t_memory = bytes_per_chip / HBM_BW
    t_coll = coll_bytes_per_chip / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["total_bound_s"] = max(t_compute, t_memory, t_coll)
    terms["n_chips"] = n_chips
    return terms


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) — 'useful' training FLOPs.
    For inference shapes: 2·N·D per forward token (prefill) and 2·N_active
    per decoded token (decode)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
