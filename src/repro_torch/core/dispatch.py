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
kernels update in place, with zero host descriptor work.  A kernel whose
tasks are all SpDMM takes the in-place body instead (:func:`in_place`):
``spdmm_fused`` reads the dense operand where it lies and writes the
``(M, N)`` result directly, with no pad, canvas fill or slice.  PyTorch
runs eagerly, so there is no trace; the trace accounting of the reference
is kept (one "build" per distinct executor signature) so cache statistics
compare.

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

The activation half (:class:`ActivationDispatch`,
:func:`apply_activation_dispatch`) lowers an activation-side (dense X)
kernel into capacity-slot descriptors that are independent of the
activation's content: the device packer
(:func:`~repro_torch.kernels.ops.pack_activation_stripes`) fills the slots
at run time, the fused kernels find their runs on the device, and a batch
that overflows its budget takes the dense ``gemm`` kernel — all with fixed
shapes and no host read, so the whole route can live inside one captured
CUDA graph (:func:`repro_torch.models.gnn.compile_model`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import halo as _halo
from repro_torch.device import as_tensor, host
from repro_torch.kernels import ops
from repro_torch.kernels.formats import BlockCSR, block_nonzero_mask


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

    ``arrays`` holds the descriptor index arrays (int32) and the pooled
    stored-block payloads (float32); the fused kernels find their runs
    themselves.  ``fingerprint`` content-addresses the (structure, task
    assignment, geometry) this dispatch lowers.  ``covered``
    (:func:`spdmm_covers`) says that the SpDMM entries write every output
    block of the logical extent from zero, so the in-place body need not
    zero its output; it is derived from ``arrays``, so it is in neither
    them nor the fingerprint."""
    geom: DispatchGeometry
    arrays: dict[str, torch.Tensor]
    fingerprint: str
    covered: bool = False

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
    structure key, kernel geometry, the ORDERED task assignment and, for a
    placed plan, the mesh bands and the operand ownership split they imply.
    Memoized on the plan instance; equal to the reference's digest for the
    same plan."""
    memo = getattr(plan, "_dispatch_digest", None)
    if memo is not None and memo[0] == block:
        return memo[1]
    h = hashlib.blake2b(digest_size=16)
    part = plan.part
    h.update(repr((plan.struct_key, part.M, part.K, part.N,
                   part.tile_m, part.tile_n, block)).encode())
    h.update(repr([(t.i, t.j, t.primitive) for t in plan.stq]).encode())
    h.update(repr([(t.i, t.j) for t in plan.dtq]).encode())
    placement = plan.placement
    if placement is not None:
        h.update(repr(("mesh", placement.n_devices,
                       placement.band_starts)).encode())
        h.update(repr(("own", _halo.ownership_starts(
            part.M, part.K, part.tile_m, placement.band_starts, block))
        ).encode())
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


def spdmm_covers(out_rows, out_cols, first, M: int, B: int,
                 n_col_stripes: int) -> bool:
    """Does every output block ``(out_row, out_col)`` that holds a row
    below ``M`` have a run that starts with ``first``?  Then the entries
    write each such block from zero, whatever the canvas held.  Numpy
    int32 entry arrays sorted by output block."""
    if len(out_rows) == 0:
        return False
    rows = np.asarray(out_rows, dtype=np.int64)
    cols = np.asarray(out_cols, dtype=np.int64)
    starts = np.ones(len(rows), dtype=bool)
    starts[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    sel = starts & (np.asarray(first) != 0) & (rows * B < M)
    keys = np.unique(rows[sel] * n_col_stripes + cols[sel])
    return keys.size == -(-M // B) * n_col_stripes


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
                   fingerprint: str = "",
                   faults: object = None) -> CompiledDispatch | None:
    """Lower a planned kernel into a :class:`CompiledDispatch` on the
    stripes' device: O(nnz blocks) of vectorized numpy plus one upload, paid
    once per (structure, assignment, geometry).  ``None`` when the canvas
    geometry cannot take the in-place layout.  ``faults`` is the optional
    fault injector probed at the ``lower`` site."""
    if faults is not None:
        faults.probe("lower", detail=f"dispatch:{part.name}")
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
    covered = False

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
        covered = spdmm_covers(out_rows, out_cols, first, part.M, B,
                               geom.nct)

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

    return CompiledDispatch(geom=geom, arrays=arrays, fingerprint=fingerprint,
                            covered=covered)


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


def _gemm_scatter_panel(geom, arrays, x, y_p, z, *, pred=None):
    """Dense-queue section on a pre-built operand panel: gather the tasks'
    row/col stripes and scatter one batched GEMM into the canvas."""
    rows, cols = arrays["gemm_rows"], arrays["gemm_cols"]
    x_p = F.pad(x, (0, 0, 0, geom.m_pad - geom.M))
    xs = x_p.reshape(geom.nrt, geom.SM, geom.K)[rows.long()]
    ys = y_p.movedim(1, 0)[cols.long()]
    return ops.gemm_batch_scatter(xs, ys, rows, cols, z, pred=pred)


def _gemm_scatter(geom, arrays, x, y, z, *, pred=None):
    """Dense-queue section on the raw dense operand (the activation
    route's entry point)."""
    return _gemm_scatter_panel(geom, arrays, x, _gemm_y_panel(geom, y), z,
                               pred=pred)


def in_place(geom: DispatchGeometry) -> bool:
    """Does a kernel of this geometry take the in-place body of
    :func:`apply_dispatch`: are all its tasks SpDMM?"""
    return geom.has_spdmm and not geom.has_gemm and not geom.has_spmm


def apply_dispatch(geom: DispatchGeometry, arrays, x, y, *,
                   covered: bool = False):
    """End-to-end executor body.  Where :func:`in_place` holds, ONE
    ``spdmm_fused`` reads ``y`` at its own row stride and writes the
    ``(M, N)`` result, allocated uninitialized when ``covered`` (the
    dispatch's :func:`spdmm_covers`) and zeroed otherwise.  Every other
    plan takes pad → batched GEMM scatter → fused SpDMM → fused SpMM →
    slice, on ONE padded canvas updated in place
    (:func:`apply_prepared`).  Both sum each element in the same order, so
    they agree bitwise.  ``x`` (the densified operand) may be ``None``
    when the plan has no dense-queue tasks."""
    if in_place(geom):
        if tuple(y.shape) != (geom.K, geom.N):
            raise ValueError(f"compiled dispatch: operand {tuple(y.shape)} "
                             f"for a ({geom.K}, {geom.N}) kernel operand")
        alloc = torch.empty if covered else torch.zeros
        z = alloc((geom.M, geom.N), dtype=torch.float32, device=y.device)
        return ops.spdmm_fused(
            arrays["sp_pool"], y, arrays["sp_a_ids"], arrays["sp_y_rows"],
            arrays["sp_out_rows"], arrays["sp_out_cols"], arrays["sp_first"],
            block_size=geom.B, bn=geom.SN, m_pad=geom.M, z=z)
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
            block_size=B, bn=SN, m_pad=M_pad, z=z)

    if geom.has_spmm:
        y_blocks = _masked_y_blocks(geom, y_f)
        z = ops.spmm_fused(
            arrays["mm_pool"], y_blocks, arrays["mm_a_ids"],
            arrays["mm_y_ids"], arrays["mm_out_rows"], arrays["mm_out_cols"],
            arrays["mm_first"], block_size=B, m_pad=M_pad, n_pad=N_pad,
            z=z)

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
    return apply_dispatch(d.geom, d.arrays, x, y, covered=d.covered)


# ------------------------------------ activation-side capacity block-skip
@dataclasses.dataclass(frozen=True)
class ActivationGeometry(DispatchGeometry):
    """Hashable static shape of a compiled ACTIVATION dispatch.

    Extends :class:`DispatchGeometry` with the stored-block budget per
    row-stripe: the descriptor arrays enumerate capacity slots, not
    concrete stored blocks, so the key distinguishes two budgets but NOT
    two sparsity patterns.  The budget is uniform (``cap``) or a per-stripe
    vector (``caps``; stripes live at flat offsets ``cumsum(caps)``)."""
    cap: int = 0
    # per-stripe budgets; empty tuple = uniform ``cap`` for every stripe
    caps: tuple = ()

    @property
    def R(self) -> int:
        return self.SM // self.B

    @property
    def C(self) -> int:
        return self.SN // self.B

    @property
    def cap_vec(self) -> np.ndarray:
        """Per-stripe budget vector (length ``nrt``)."""
        if self.caps:
            return np.asarray(self.caps, dtype=np.int64)
        return np.full(self.nrt, self.cap, dtype=np.int64)

    @property
    def total_slots(self) -> int:
        return int(self.cap_vec.sum())


@dataclasses.dataclass
class ActivationDispatch:
    """Capacity-parameterized instruction stream of one activation-side
    (dense X) kernel.  ``arrays`` holds ONLY static int32 arrays — slot
    ids, output col-stripes, base rows (the reference's descriptors) and
    ``act_caps``, the budget vector on the device, which the packer needs
    inside a captured program — valid for every input; the data-dependent
    half (block payloads, per-slot block-row/col/first) is produced at run
    time by the device packer and joined to these descriptors."""
    geom: ActivationGeometry
    arrays: dict[str, torch.Tensor]
    fingerprint: str


def _canvas_rc(part, block: int) -> tuple[int, int]:
    SM, _ = canvas_slots(part, block)
    return SM // block, -(-part.K // block)


def _stripe_needs(x, part, block: int, *, eps: float = 0.0):
    """Per-stripe slot needs of a warmup activation (stored blocks plus one
    filler per empty block-row, canvas padding rows included); ``None`` for
    canvas-misaligned geometry."""
    slots = canvas_slots(part, block)
    if slots is None:
        return None
    SM, _ = slots
    B = block
    S, R, C = part.n_row_tiles, SM // B, -(-part.K // B)
    x = host(x)
    xp = np.zeros((S * R * B, C * B), dtype=x.dtype)
    xp[: x.shape[0], : x.shape[1]] = x
    xb = xp.reshape(S, R, B, C, B)
    mask = block_nonzero_mask(xb, eps, axis=(2, 4))
    return np.maximum(mask.sum(axis=2), 1).sum(axis=1)     # (S,)


def activation_capacity(x, part, block: int, *, eps: float = 0.0,
                        slack: float = 1.5) -> int | None:
    """Uniform stored-block budget per row-stripe from a warmup activation:
    the largest stripe need times ``slack``, clamped to ``[1, R*C]``, so
    later batches whose sparsity wiggles still fit without a new capture.
    ``None`` when the canvas geometry cannot take the in-place layout."""
    needs = _stripe_needs(x, part, block, eps=eps)
    if needs is None:
        return None
    R, C = _canvas_rc(part, block)
    return min(R * C, max(1, math.ceil(int(needs.max()) * slack)))


def activation_budgets(x, part, block: int, *, eps: float = 0.0,
                       slack: float = 1.5):
    """Per-stripe stored-block budget VECTOR from a warmup activation: each
    stripe budgeted at its own need × ``slack`` (clamped to ``[1, R*C]``),
    so skewed activations do not pad every stripe to the densest one's
    need.  int64 array of length ``part.n_row_tiles``, or ``None`` for
    canvas-misaligned geometry."""
    needs = _stripe_needs(x, part, block, eps=eps)
    if needs is None:
        return None
    R, C = _canvas_rc(part, block)
    return np.clip(np.ceil(needs * slack).astype(np.int64), 1, R * C)


def build_activation_dispatch(part, stq, dtq, *, block: int, capacity,
                              eps: float = 0.0, fingerprint: str = "",
                              device="cpu", faults: object = None
                              ) -> ActivationDispatch | None:
    """Lower an activation-side plan into capacity-slot descriptor arrays
    on ``device``.

    ``capacity`` is a uniform int budget or a per-stripe vector;
    descriptors address slots at the stripe's flat offset.  Entry order is
    (task, slot) for SpDMM and (task, y-block-col, slot) for SpMM: within
    one ordering unit the packer's slot metadata is row-major, so every
    output block is visited in ONE consecutive run for ANY stored pattern,
    and the real contributions arrive in the order the eager host pack
    emits, so sums are bit-identical.  ``None`` for canvas geometries the
    in-place layout cannot take.  ``faults`` is the optional fault injector
    probed at the ``pack`` site."""
    if faults is not None:
        faults.probe("pack", detail=f"act:{part.name}")
    slots = canvas_slots(part, block)
    if slots is None:
        return None
    SM, SN = slots
    B = block
    R, C = SM // B, SN // B
    cap_arr = np.asarray(capacity, dtype=np.int64)
    uniform = cap_arr.ndim == 0
    if uniform:
        cap_arr = np.full(part.n_row_tiles, int(cap_arr), dtype=np.int64)
    assert cap_arr.shape == (part.n_row_tiles,), (cap_arr.shape, part)
    offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(cap_arr)])
    geom = ActivationGeometry(
        M=part.M, K=part.K, N=part.N, tm=part.tile_m, tn=part.tile_n,
        SM=SM, SN=SN, B=B, nrt=part.n_row_tiles, nct=part.n_col_tiles,
        cap=int(cap_arr[0]) if uniform else 0,
        caps=() if uniform else tuple(int(c) for c in cap_arr),
        eps=eps,
        has_gemm=bool(dtq),
        has_spdmm=any(t.primitive != "SpMM" for t in stq),
        has_spmm=any(t.primitive == "SpMM" for t in stq))
    up = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32),
                                   device=device)
    arrays: dict[str, torch.Tensor] = {"act_caps": up(cap_arr)}

    if dtq:
        arrays["gemm_rows"] = up([t.i for t in dtq])
        arrays["gemm_cols"] = up([t.j for t in dtq])

    spdmm_tasks = sorted((t for t in stq if t.primitive != "SpMM"),
                         key=lambda t: (t.i, t.j))
    spmm_tasks = sorted((t for t in stq if t.primitive == "SpMM"),
                        key=lambda t: (t.i, t.j))

    if spdmm_tasks:
        arrays["asp_a_ids"] = up(np.concatenate(
            [offs[t.i] + np.arange(cap_arr[t.i], dtype=np.int64)
             for t in spdmm_tasks]))
        arrays["asp_out_cols"] = up(np.concatenate(
            [np.full(cap_arr[t.i], t.j, dtype=np.int64)
             for t in spdmm_tasks]))
        arrays["asp_base_rows"] = up(np.concatenate(
            [np.full(cap_arr[t.i], t.i * R, dtype=np.int64)
             for t in spdmm_tasks]))

    if spmm_tasks:
        a_ids, y_cols, base_rows = [], [], []
        for t in spmm_tasks:
            nbj = -(-part.col_extent(t.j) // B)
            cap_i = int(cap_arr[t.i])
            a_ids.append(np.tile(
                offs[t.i] + np.arange(cap_i, dtype=np.int64), nbj))
            y_cols.append(np.repeat(t.j * C + np.arange(nbj, dtype=np.int64),
                                    cap_i))
            base_rows.append(np.full(nbj * cap_i, t.i * R, dtype=np.int64))
        arrays["amm_a_ids"] = up(np.concatenate(a_ids))
        # y block-col == output block-col for every triple of a task
        arrays["amm_y_cols"] = up(np.concatenate(y_cols))
        arrays["amm_base_rows"] = up(np.concatenate(base_rows))

    return ActivationDispatch(geom=geom, arrays=arrays,
                              fingerprint=fingerprint)


def apply_activation_dispatch(geom: ActivationGeometry, arrays, x, y):
    """Activation-side executor: device-pack X into capacity slots, join
    the slot metadata to the static descriptors, and drain the plan's
    queues on one canvas — or, when the batch overflows the budget, take
    the dense ``gemm`` result.

    Both branches are launched and each kernel is predicated on the
    packer's overflow flag, read on the device: the skip route's kernels
    run only without overflow, the dense ``gemm`` only with it, and
    ``torch.where`` picks the branch that ran.  The reference's
    ``lax.cond`` thus becomes straight-line code with no host read, which
    a CUDA graph can capture; on the CPU (plain versions) both branches
    compute.  The fused kernels find their runs on the device, from the
    key changes of the descriptors, because the descriptors
    ``base_rows + row_m[a_ids]`` exist only at run time.

    Returns ``(z, diag)``: ``diag`` carries the block-skip telemetry —
    ``stored`` (real blocks packed, a device scalar), ``capacity`` /
    ``logical`` (the budget and the logical block count) and the
    ``overflow`` flag (a device bool)."""
    B, SN = geom.B, geom.SN
    (pool, row_m, col_m, first_m, _nnzb, real,
     overflow) = ops.pack_activation_stripes(
        x, block=B, n_stripes=geom.nrt, slot_rows=geom.R,
        n_block_cols=geom.ncb, capacity=geom.cap_vec, eps=geom.eps,
        caps=arrays["act_caps"])
    flag = overflow.to(torch.int32).reshape(1)
    z_dense = ops.gemm(x, y, out_dtype=torch.float32, pred=(flag, 1))
    skip = (flag, 0)
    z = torch.zeros((geom.m_pad, geom.n_pad), dtype=torch.float32,
                    device=y.device)
    if geom.has_gemm:
        z = _gemm_scatter(geom, arrays, x, y, z, pred=skip)
    if geom.has_spdmm or geom.has_spmm:
        y_f = _stripe_padded_y(geom, y)
    if geom.has_spdmm:
        a_ids = arrays["asp_a_ids"]
        slot = a_ids.long()
        z = ops.spdmm_fused(
            pool, y_f, a_ids, col_m[slot],
            arrays["asp_base_rows"] + row_m[slot], arrays["asp_out_cols"],
            first_m[slot], block_size=B, bn=SN, m_pad=geom.m_pad, z=z,
            pred=skip)
    if geom.has_spmm:
        y_blocks = _masked_y_blocks(geom, y_f)
        a_ids = arrays["amm_a_ids"]
        slot = a_ids.long()
        y_ids = col_m[slot] * (geom.nct * geom.C) + arrays["amm_y_cols"]
        z = ops.spmm_fused(
            pool, y_blocks, a_ids, y_ids,
            arrays["amm_base_rows"] + row_m[slot], arrays["amm_y_cols"],
            first_m[slot], block_size=B, m_pad=geom.m_pad,
            n_pad=geom.n_pad, z=z, pred=skip)
    z = torch.where(overflow, z_dense, z[:geom.M, :geom.N])
    # ``stored`` counts REAL blocks (empty-row fillers excluded) and
    # ``logical`` the block positions of the LOGICAL extent, so
    # 1 - stored/logical is the honest skip ratio
    diag = {
        "stored": real.sum(),
        "capacity": geom.total_slots,
        "logical": -(-geom.M // geom.B) * geom.ncb,
        "overflow": overflow,
    }
    return z, diag


def execute_activation(d: ActivationDispatch, x, y, *, stats=None):
    """Run one activation-side kernel through the capacity block-skip
    route; the same executor serves EVERY input sparsity within budget.
    Returns ``(z, diag)``; ``stats`` receives the same executor-signature
    accounting as :func:`execute_dispatch`."""
    dev = d.arrays["act_caps"].device
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    key = _signature(d.geom, d.arrays, x, y)
    with _TRACE_LOCK:
        hit = key in _TRACE_SEEN
        _TRACE_SEEN.add(key)
    if stats is not None:
        if hit:
            stats.trace_cache_hits += 1
        else:
            stats.trace_builds += 1
    return apply_activation_dispatch(d.geom, d.arrays, x, y)
