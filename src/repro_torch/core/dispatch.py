"""Compiled dispatch — plan-time lowering of a plan into an instruction stream.

The paper's runtime does its sparsity analysis and kernel mapping ONCE and
then streams work to the PL/AIE engines with near-zero per-kernel overhead
(§III, Alg. 4).  A planned adjacency kernel is lowered into a
:class:`CompiledDispatch` — the sorted fused-kernel descriptor arrays (SpDMM
entry list, SpMM triple list, batched-GEMM tile coordinates), the pooled
BlockCSR block payloads, the run offsets of each fused list and the
padded-canvas geometry — built once with vectorized numpy and kept
device-resident in the :class:`~repro_torch.core.plancache.PlanCache`.

Steady-state execution then goes through :func:`execute_dispatch`: pad →
gemm_batch_scatter → spdmm_fused → spmm_fused → slice on one canvas the
kernels update in place, with zero host descriptor work.  PyTorch runs
eagerly, so there is no trace; the trace accounting of the reference is kept
(one "build" per distinct executor signature) so cache statistics compare.

Semantics vs the eager batched path (`scheduler._execute_batched`):

- GEMM and SpDMM lower exactly the same operations in the same order —
  bit-identical by construction.
- SpMM descriptors are Y-structure-independent so they can be cached: the
  triple list pairs every stored A block with EVERY logical Y block of the
  task's col-stripe.  The extra pairs multiply real A blocks into
  exactly-zero Y blocks, and ``x + (±0) == x`` bitwise for every value the
  accumulator can take, so the result is still bit-identical.  With
  ``eps != 0`` Y blocks whose magnitudes are all ``<= eps`` are zeroed on
  the device before the kernel, turning their pairs into the same no-ops.

The activation half (capacity-padded dense-X block-skip) comes with the
whole-model compile slice of the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import host
from repro_torch.kernels import ops
from repro_torch.kernels.formats import (BlockCSR, block_nonzero_mask,
                                         run_starts)


def canvas_slots(part, block: int) -> tuple[int, int] | None:
    """Slot sizes ``(SM, SN)`` of the padded in-place canvas, or ``None``
    when the geometry cannot use the in-place layout (interior tile
    boundaries not lcm(block, 8)-aligned)."""
    align = math.lcm(block, 8)
    tm, tn = part.tile_m, part.tile_n
    SM = tm if tm % align == 0 else -(-tm // align) * align
    SN = tn if tn % align == 0 else -(-tn // align) * align
    if (part.n_row_tiles > 1 and SM != tm) or (part.n_col_tiles > 1 and SN != tn):
        return None
    return SM, SN


@dataclasses.dataclass(frozen=True)
class DispatchGeometry:
    """Hashable static shape of a compiled dispatch."""
    M: int
    K: int
    N: int
    tm: int
    tn: int
    SM: int
    SN: int
    B: int
    nrt: int
    nct: int
    has_gemm: bool
    has_spdmm: bool
    has_spmm: bool
    # nonzero tolerance applied to the dense operand's blocks before the
    # SpMM (sub-eps Y blocks are zeroed on device — see module doc)
    eps: float = 0.0

    @property
    def m_pad(self) -> int:
        return self.nrt * self.SM

    @property
    def n_pad(self) -> int:
        return self.nct * self.SN

    @property
    def ncb(self) -> int:
        return -(-self.K // self.B)


@dataclasses.dataclass
class CompiledDispatch:
    """Device-resident instruction stream of one planned kernel.

    ``arrays`` holds the descriptor index arrays (int32), the pooled
    stored-block payloads (float32) and the run offsets of each fused list
    (``sp_runs`` / ``mm_runs``).  ``fingerprint`` content-addresses the
    (structure, task assignment, geometry) this dispatch lowers."""
    geom: DispatchGeometry
    arrays: dict[str, torch.Tensor]
    fingerprint: str

    @property
    def needs_x(self) -> bool:
        """True when the dense-queue gather needs the densified X operand."""
        return self.geom.has_gemm

    @property
    def n_entries(self) -> int:
        a = self.arrays.get("sp_a_ids")
        return 0 if a is None else int(a.shape[0])

    @property
    def n_triples(self) -> int:
        a = self.arrays.get("mm_a_ids")
        return 0 if a is None else int(a.shape[0])


def plan_digest(plan, block: int) -> str:
    """Content digest of everything a dispatch is lowered from: operand
    structure key, kernel geometry, and the ORDERED task assignment.
    Memoized on the plan instance; equal to the reference's digest for the
    same (unsharded) plan."""
    memo = getattr(plan, "_dispatch_digest", None)
    if memo is not None and memo[0] == block:
        return memo[1]
    h = hashlib.blake2b(digest_size=16)
    part = plan.part
    h.update(repr((plan.struct_key, part.M, part.K, part.N,
                   part.tile_m, part.tile_n, block)).encode())
    h.update(repr([(t.i, t.j, t.primitive) for t in plan.stq]).encode())
    h.update(repr([(t.i, t.j) for t in plan.dtq]).encode())
    digest = h.hexdigest()
    plan._dispatch_digest = (block, digest)
    return digest


def _stripe_pool(tasks, stripes) -> tuple[dict[int, int], torch.Tensor]:
    """Concatenate the stored blocks of every row-stripe a task list touches
    into one device pool; returns (stripe index -> pool offset, pool)."""
    offsets: dict[int, int] = {}
    pool = []
    off = 0
    for i in sorted({t.i for t in tasks}):
        offsets[i] = off
        pool.append(stripes[i].blocks[: stripes[i].nnzb])
        off += stripes[i].nnzb
    return offsets, torch.cat(pool, dim=0)


def spdmm_entry_arrays(tasks, stripes: dict[int, BlockCSR],
                       offsets: dict[int, int], R: int):
    """Vectorized fused-SpDMM entry list over all tasks of one kernel.

    Returns numpy int32 ``(a_ids, y_rows, out_rows, out_cols, first)`` sorted
    by output block with queue order as the tiebreak (the stripes' own
    ``first`` flags are carried through the sort)."""
    out_rows, out_cols, a_ids, y_rows, firsts = [], [], [], [], []
    for task in tasks:
        s = stripes[task.i]
        nb = s.nnzb
        rid = host(s.row_ids)[:nb]
        out_rows.append(task.i * R + rid.astype(np.int64))
        out_cols.append(np.full(nb, task.j, dtype=np.int64))
        a_ids.append(offsets[task.i] + np.arange(nb, dtype=np.int64))
        y_rows.append(host(s.col_ids)[:nb].astype(np.int64))
        firsts.append(host(s.first)[:nb].astype(np.int64))
    out_rows = np.concatenate(out_rows)
    out_cols = np.concatenate(out_cols)
    a_ids = np.concatenate(a_ids)
    y_rows = np.concatenate(y_rows)
    firsts = np.concatenate(firsts)
    seq = np.arange(len(out_rows))
    order = np.lexsort((seq, out_cols, out_rows))
    return (a_ids[order].astype(np.int32), y_rows[order].astype(np.int32),
            out_rows[order].astype(np.int32), out_cols[order].astype(np.int32),
            firsts[order].astype(np.int32))


def _spmm_dense_y_triples(tasks, part, stripes, offsets, R: int, C: int,
                          n_y_block_cols: int):
    """Vectorized fused-SpMM triple list with a Y-structure-INDEPENDENT
    pairing: every stored A block of a task's row-stripe is paired with every
    logical Y block of the task's col-stripe (``y_id = ib * Ctot + cb`` into
    the row-major pool :func:`repro_torch.kernels.ops.blockize` builds from
    the dense operand at run time)."""
    out_rows, out_cols, a_ids, y_ids = [], [], [], []
    for task in tasks:
        s = stripes[task.i]
        nb = s.nnzb
        nbj = -(-part.col_extent(task.j) // s.block_size)
        rid = host(s.row_ids)[:nb].astype(np.int64)
        cid = host(s.col_ids)[:nb].astype(np.int64)
        kb = np.tile(np.arange(nbj, dtype=np.int64), nb)
        out_rows.append(np.repeat(task.i * R + rid, nbj))
        out_cols.append(task.j * C + kb)
        a_ids.append(np.repeat(offsets[task.i] + np.arange(nb, dtype=np.int64),
                               nbj))
        y_ids.append(np.repeat(cid, nbj) * n_y_block_cols + task.j * C + kb)
    out_rows = np.concatenate(out_rows)
    out_cols = np.concatenate(out_cols)
    a_ids = np.concatenate(a_ids)
    y_ids = np.concatenate(y_ids)
    order = np.lexsort((y_ids, a_ids, out_cols, out_rows))
    out_rows, out_cols = out_rows[order], out_cols[order]
    first = np.ones(len(out_rows), dtype=np.int32)
    if len(first) > 1:
        same = ((out_rows[1:] == out_rows[:-1])
                & (out_cols[1:] == out_cols[:-1]))
        first[1:][same] = 0
    return (a_ids[order].astype(np.int32), y_ids[order].astype(np.int32),
            out_rows.astype(np.int32), out_cols.astype(np.int32), first)


def build_dispatch(part, stq, dtq, stripes: dict[int, BlockCSR],
                   *, block: int, eps: float = 0.0,
                   fingerprint: str = "") -> CompiledDispatch | None:
    """Lower a planned kernel into a :class:`CompiledDispatch` on the
    stripes' device: O(nnz blocks) of vectorized numpy plus one upload, paid
    once per (structure, assignment, geometry).  ``None`` when the canvas
    geometry cannot take the in-place layout."""
    slots = canvas_slots(part, block)
    if slots is None:
        return None
    SM, SN = slots
    B = block
    R, C = SM // B, SN // B
    geom = DispatchGeometry(
        M=part.M, K=part.K, N=part.N, tm=part.tile_m, tn=part.tile_n,
        SM=SM, SN=SN, B=B, nrt=part.n_row_tiles, nct=part.n_col_tiles,
        has_gemm=bool(dtq),
        has_spdmm=any(t.primitive != "SpMM" for t in stq),
        has_spmm=any(t.primitive == "SpMM" for t in stq),
        eps=eps)
    dev = next(iter(stripes.values())).blocks.device if stripes else "cpu"
    up = lambda a: torch.as_tensor(a, device=dev)
    arrays: dict[str, torch.Tensor] = {}

    if dtq:
        arrays["gemm_rows"] = up(np.array([t.i for t in dtq], dtype=np.int32))
        arrays["gemm_cols"] = up(np.array([t.j for t in dtq], dtype=np.int32))

    spdmm_tasks = [t for t in stq if t.primitive != "SpMM"]
    spmm_tasks = [t for t in stq if t.primitive == "SpMM"]

    if spdmm_tasks:
        offsets, pool = _stripe_pool(spdmm_tasks, stripes)
        a_ids, y_rows, out_rows, out_cols, first = spdmm_entry_arrays(
            spdmm_tasks, stripes, offsets, R)
        arrays["sp_pool"] = pool
        arrays["sp_a_ids"] = up(a_ids)
        arrays["sp_y_rows"] = up(y_rows)
        arrays["sp_out_rows"] = up(out_rows)
        arrays["sp_out_cols"] = up(out_cols)
        arrays["sp_first"] = up(first)
        arrays["sp_runs"] = run_starts(arrays["sp_out_rows"],
                                       arrays["sp_out_cols"])

    if spmm_tasks:
        offsets, pool = _stripe_pool(spmm_tasks, stripes)
        a_ids, y_ids, out_rows, out_cols, first = _spmm_dense_y_triples(
            spmm_tasks, part, stripes, offsets, R, C,
            n_y_block_cols=geom.nct * C)
        arrays["mm_pool"] = pool
        arrays["mm_a_ids"] = up(a_ids)
        arrays["mm_y_ids"] = up(y_ids)
        arrays["mm_out_rows"] = up(out_rows)
        arrays["mm_out_cols"] = up(out_cols)
        arrays["mm_first"] = up(first)
        arrays["mm_runs"] = run_starts(arrays["mm_out_rows"],
                                       arrays["mm_out_cols"])

    return CompiledDispatch(geom=geom, arrays=arrays, fingerprint=fingerprint)


# --------------------------------------------------------------- execution
def _stripe_padded_y(geom, y):
    """Dense operand laid out with each col-stripe padded to ``SN`` columns
    and K padded to block multiples — the fused kernels' Y layout."""
    B = geom.B
    ncb = geom.ncb
    y_pad = F.pad(y, (0, geom.nct * geom.tn - geom.N, 0, ncb * B - geom.K))
    return F.pad(y_pad.reshape(ncb * B, geom.nct, geom.tn),
                 (0, geom.SN - geom.tn)).reshape(ncb * B, geom.nct * geom.SN)


def _masked_y_blocks(geom, y_f):
    """Blockized dense operand with the eps mask applied on device: blocks
    whose magnitudes are all ``<= eps`` are zeroed, so the
    structure-independent pairing contributes exact bitwise no-ops for
    exactly the blocks an eps-thresholded eager pack would have dropped."""
    y_blocks = ops.blockize(y_f, geom.B)
    if geom.eps != 0.0:
        keep = block_nonzero_mask(y_blocks, geom.eps, axis=(-2, -1), xp=torch)
        y_blocks = torch.where(keep[:, None, None], y_blocks,
                               torch.zeros((), dtype=y_blocks.dtype,
                                           device=y_blocks.device))
    return y_blocks


def _gemm_y_panel(geom, y):
    """Col-stripe-padded GEMM operand panel ``(K, nct, SN)``."""
    y_p = F.pad(y, (0, geom.nct * geom.tn - geom.N)).reshape(
        geom.K, geom.nct, geom.tn)
    if geom.SN != geom.tn:
        y_p = F.pad(y_p, (0, geom.SN - geom.tn))
    return y_p


def _gemm_scatter_panel(geom, arrays, x, y_p, z):
    """Dense-queue section on a pre-built operand panel: gather the tasks'
    row/col stripes and scatter one batched GEMM into the canvas."""
    rows, cols = arrays["gemm_rows"], arrays["gemm_cols"]
    x_p = F.pad(x, (0, 0, 0, geom.m_pad - geom.M))
    xs = x_p.reshape(geom.nrt, geom.SM, geom.K)[rows.long()]
    ys = y_p.movedim(1, 0)[cols.long()]
    return ops.gemm_batch_scatter(xs, ys, rows, cols, z)


def apply_dispatch(geom: DispatchGeometry, arrays, x, y):
    """End-to-end executor body: pad → batched GEMM scatter → fused SpDMM →
    fused SpMM → slice, on ONE canvas updated in place.  ``x`` (the
    densified operand) may be ``None`` when the plan has no dense-queue
    tasks."""
    if geom.has_gemm and x is None:
        raise ValueError("compiled dispatch: dense-queue tasks need the "
                         "densified x operand (got x=None)")
    y_f = (_stripe_padded_y(geom, y)
           if (geom.has_spdmm or geom.has_spmm) else None)
    y_p = _gemm_y_panel(geom, y) if geom.has_gemm else None
    return apply_prepared(geom, arrays, x, y_f, y_p)


def apply_prepared(geom: DispatchGeometry, arrays, x, y_f, y_p):
    """Executor body on PRE-LAID-OUT dense operands: ``y_f`` is the
    stripe-padded operand matrix, ``y_p`` the GEMM panel (required when
    ``geom.has_gemm``)."""
    B, SN = geom.B, geom.SN
    M_pad, N_pad = geom.m_pad, geom.n_pad
    dev = (y_f if y_f is not None else y_p).device
    z = torch.zeros((M_pad, N_pad), dtype=torch.float32, device=dev)

    if geom.has_gemm:
        z = _gemm_scatter_panel(geom, arrays, x, y_p, z)

    if geom.has_spdmm:
        z = ops.spdmm_fused(
            arrays["sp_pool"], y_f, arrays["sp_a_ids"], arrays["sp_y_rows"],
            arrays["sp_out_rows"], arrays["sp_out_cols"], arrays["sp_first"],
            block_size=B, bn=SN, m_pad=M_pad, z=z, runs=arrays["sp_runs"])

    if geom.has_spmm:
        y_blocks = _masked_y_blocks(geom, y_f)
        z = ops.spmm_fused(
            arrays["mm_pool"], y_blocks, arrays["mm_a_ids"],
            arrays["mm_y_ids"], arrays["mm_out_rows"], arrays["mm_out_cols"],
            arrays["mm_first"], block_size=B, m_pad=M_pad, n_pad=N_pad,
            z=z, runs=arrays["mm_runs"])

    return z[:geom.M, :geom.N]


# Executor-signature accounting: the reference counts jit traces per
# (geometry, operand signature); the port keeps the same key set so cache
# statistics (trace_builds / trace_cache_hits) compare between packages.
_TRACE_SEEN: set = set()
_TRACE_LOCK = threading.Lock()


def _signature(geom, arrays, x, y):
    arr_sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in arrays.items()))
    x_sig = None if x is None else (tuple(x.shape), str(x.dtype))
    return (geom, arr_sig, x_sig, tuple(y.shape), str(y.dtype), str(y.device))


def reset_trace_registry() -> None:
    """Forget which executor signatures were seen (tests/benchmarks)."""
    with _TRACE_LOCK:
        _TRACE_SEEN.clear()


def execute_dispatch(d: CompiledDispatch, x, y, *, stats=None) -> torch.Tensor:
    """Run one compiled kernel with zero host descriptor work.  ``stats``
    (a ``CacheStats``) receives the executor-signature accounting."""
    key = _signature(d.geom, d.arrays, x, y)
    with _TRACE_LOCK:
        hit = key in _TRACE_SEEN
        _TRACE_SEEN.add(key)
    if stats is not None:
        if hit:
            stats.trace_cache_hits += 1
        else:
            stats.trace_builds += 1
    return apply_dispatch(d.geom, d.arrays, x, y)
