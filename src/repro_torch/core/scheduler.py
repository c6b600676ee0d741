"""Scheduler — Algorithm 4 lines 13-21.

Two roles:

1. ``simulate``: event-driven list scheduling of the two task queues onto the
   sparse units (8 ALU arrays on VCK5000) and the single dense engine (AIE
   array / MXU), exactly the paper's idle-unit pop loop.  Returns makespan and
   per-unit busy time — the cycle-estimate backend (the paper's own
   evaluation methodology: a perf-model-driven simulator with a DDR
   bandwidth bound, §IV-A).

2. ``execute_plan``: literal functional execution of a plan — each queue is
   drained with its real fused kernel (``gemm_batch_scatter`` /
   ``spdmm_fused`` / ``spmm_fused``) onto one in-place canvas, or, with
   ``batched=False`` and for canvas-misaligned tile geometry, task by task
   (``gemm`` / ``spdmm`` / ``spmm``, one launch per task).  The engine uses
   it for activation-side (dense X) kernels.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dispatch as _dispatch
from repro_torch.core.partition import KernelPartition, Task
from repro_torch.core.perfmodel import HardwareModel, flops, data_count
from repro_torch.device import host
from repro_torch.kernels import ops
from repro_torch.kernels.formats import (BlockCSR, first_visit_flags,
                                         pack_blockcsr, pair_block_triples)


@dataclasses.dataclass
class ScheduleReport:
    makespan: float                 # seconds (hardware execution time)
    t_sparse_busy: float            # Σ busy time over sparse units
    t_dense_busy: float             # busy time of the dense engine
    n_stq: int
    n_dtq: int
    n_spdmm: int
    n_spmm: int
    flops_executed: float
    flops_dense_equiv: float        # FLOPs had every task run as GEMM
    data_loaded: float              # elements (Table V "#Data")
    data_dense_equiv: float
    memory_time: float              # total bytes / BW (bandwidth bound)
    # sharded plans: one sub-report per mesh device (empty when unsharded).
    # The scalar fields above stay the combined view (makespan = slowest
    # device; busy/flops/data = totals) so existing consumers are unchanged.
    per_device: tuple = ()

    @classmethod
    def zero(cls) -> "ScheduleReport":
        """Identity element of ``merge`` — the report of zero kernels."""
        return cls(makespan=0.0, t_sparse_busy=0.0, t_dense_busy=0.0,
                   n_stq=0, n_dtq=0, n_spdmm=0, n_spmm=0,
                   flops_executed=0.0, flops_dense_equiv=0.0,
                   data_loaded=0.0, data_dense_equiv=0.0, memory_time=0.0)

    def merge(self, other: "ScheduleReport") -> "ScheduleReport":
        per_device: tuple = ()
        if self.per_device or other.per_device:
            a, b = list(self.per_device), list(other.per_device)
            n = max(len(a), len(b))
            a += [ScheduleReport.zero()] * (n - len(a))
            b += [ScheduleReport.zero()] * (n - len(b))
            per_device = tuple(x.merge(y) for x, y in zip(a, b))
        return ScheduleReport(
            makespan=self.makespan + other.makespan,
            t_sparse_busy=self.t_sparse_busy + other.t_sparse_busy,
            t_dense_busy=self.t_dense_busy + other.t_dense_busy,
            n_stq=self.n_stq + other.n_stq,
            n_dtq=self.n_dtq + other.n_dtq,
            n_spdmm=self.n_spdmm + other.n_spdmm,
            n_spmm=self.n_spmm + other.n_spmm,
            flops_executed=self.flops_executed + other.flops_executed,
            flops_dense_equiv=self.flops_dense_equiv + other.flops_dense_equiv,
            data_loaded=self.data_loaded + other.data_loaded,
            data_dense_equiv=self.data_dense_equiv + other.data_dense_equiv,
            memory_time=self.memory_time + other.memory_time,
            per_device=per_device,
        )

    def scaled(self, s: float) -> "ScheduleReport":
        """Cost fields scaled by ``s`` — the per-request attribution the
        serving layer uses for a micro-batch share.  The task / primitive
        counts describe the shared fused launches and are left intact."""
        return dataclasses.replace(
            self,
            makespan=self.makespan * s,
            t_sparse_busy=self.t_sparse_busy * s,
            t_dense_busy=self.t_dense_busy * s,
            flops_executed=self.flops_executed * s,
            flops_dense_equiv=self.flops_dense_equiv * s,
            data_loaded=self.data_loaded * s,
            data_dense_equiv=self.data_dense_equiv * s,
            memory_time=self.memory_time * s,
            per_device=tuple(r.scaled(s) for r in self.per_device),
        )


def simulate(stq: list[Task], dtq: list[Task], hw: HardwareModel) -> ScheduleReport:
    """List-schedule STQ onto ``hw.n_sparse_units`` ALU arrays and DTQ onto
    the dense engine; makespan = max(compute makespan, memory time)."""
    # sparse units: min-heap of available times
    sparse_free = [0.0] * hw.n_sparse_units
    heapq.heapify(sparse_free)
    sparse_busy = 0.0
    for task in stq:
        t0 = heapq.heappop(sparse_free)
        heapq.heappush(sparse_free, t0 + task.t_sparse)
        sparse_busy += task.t_sparse
    sparse_makespan = max(sparse_free) if sparse_free else 0.0

    dense_busy = sum(t.t_dense for t in dtq)

    # Both engines run concurrently (PL ∥ AIE): compute makespan is the max.
    compute_makespan = max(sparse_makespan, dense_busy)

    f_exec = sum(flops(t.shape, t.primitive) for t in stq + dtq)
    f_dense = sum(flops(t.shape, "GEMM") for t in stq + dtq)
    d_load = sum(data_count(t.shape, t.primitive) for t in stq + dtq)
    d_dense = sum(data_count(t.shape, "GEMM") for t in stq + dtq)
    memory_time = d_load * hw.bytes_per_elem / hw.mem_bw

    return ScheduleReport(
        makespan=max(compute_makespan, memory_time),
        t_sparse_busy=sparse_busy,
        t_dense_busy=dense_busy,
        n_stq=len(stq),
        n_dtq=len(dtq),
        n_spdmm=sum(1 for t in stq if t.primitive == "SpDMM"),
        n_spmm=sum(1 for t in stq if t.primitive == "SpMM"),
        flops_executed=f_exec,
        flops_dense_equiv=f_dense,
        data_loaded=d_load,
        data_dense_equiv=d_dense,
        memory_time=memory_time,
    )


def simulate_sharded(
    stq: list[Task],
    dtq: list[Task],
    placement,
    hws: list[HardwareModel],
) -> ScheduleReport:
    """Simulate a device-placed plan: each device runs its band's queues
    concurrently with every other device.  Combined makespan is the slowest
    device; busy times / flops / data are totals; ``per_device`` carries the
    per-device sub-reports for :attr:`EngineReport.by_device`."""
    if placement.n_devices != len(hws):
        raise ValueError(f"placement has {placement.n_devices} devices, "
                         f"got {len(hws)} hardware models")
    per_dev = [simulate([t for t in stq if t.device == d],
                        [t for t in dtq if t.device == d], hw)
               for d, hw in enumerate(hws)]
    combined = ScheduleReport.zero()
    for rep in per_dev:
        combined = combined.merge(rep)
    return dataclasses.replace(
        combined,
        makespan=max((r.makespan for r in per_dev), default=0.0),
        per_device=tuple(per_dev),
    )


def execute_plan(
    part: KernelPartition,
    stq: list[Task],
    dtq: list[Task],
    x,
    y,
    *,
    block: int = 8,
    batched: bool = True,
    packed: dict[int, BlockCSR] | None = None,
    eps: float = 0.0,
) -> torch.Tensor:
    """Drain both queues with their REAL kernels and assemble Z.

    ``x``/``y`` are dense tensors on one device.  The batched drain is the
    paper's whole-queue drain (Alg. 4 lines 13-21): the Dense Task Queue is
    ONE ``gemm_batch_scatter`` launch and the Sparse Task Queue's SpDMM /
    SpMM tasks are flattened into one entry / triple list each, one fused
    launch per primitive, all scattering into ONE shared padded canvas that
    the kernels update in place — assembly is a single slice.

    ``packed`` optionally supplies pre-packed BlockCSR row-stripes of ``x``
    (index -> BlockCSR); missing stripes are packed on the host from ``x``
    (a device-to-host copy per stripe, as in the reference).
    ``batched=False`` keeps the one-launch-per-task path for equivalence
    testing.  ``x`` may be ``None`` when ``packed`` covers every stripe the
    sparse queue touches AND the dense queue is empty — the graph-scale
    mode where the operand is never densified.
    """
    if batched:
        return _execute_batched(part, stq, dtq, x, y, block=block,
                                packed=packed, eps=eps)
    return _execute_pertask(part, stq, dtq, x, y, block=block, eps=eps,
                            packed=packed)


def _execute_pertask(part, stq, dtq, x, y, *, block, eps=0.0, packed=None):
    """One kernel launch per task — ``gemm`` for the dense queue, ``spdmm``
    or ``spmm`` for the sparse queue on the task's BlockCSR row-stripe —
    each tile written into the ``(M, N)`` result on the device.  Host
    copies of ``x`` / ``y`` are made at most once, only when a stripe must
    be packed."""
    tm, tn = part.tile_m, part.tile_n
    z = torch.zeros((part.M, part.N), dtype=torch.float32, device=y.device)
    x_host = None
    y_host = None

    if dtq and x is None:
        raise ValueError("execute_plan: dense-queue tasks need the "
                         "densified x operand (got x=None)")
    for task in dtq:  # dense engine
        xs = x[task.i * tm:(task.i + 1) * tm, :]
        ys = y[:, task.j * tn:(task.j + 1) * tn]
        z[task.i * tm:task.i * tm + xs.shape[0],
          task.j * tn:task.j * tn + ys.shape[1]] = ops.gemm(
            xs, ys, out_dtype=torch.float32)

    for task in stq:  # sparse engine: block-skip kernels
        if packed is not None and task.i in packed:
            x_bcsr = packed[task.i]
        elif x is None:
            raise ValueError(
                f"execute_plan: row-stripe {task.i} is missing from `packed` "
                "and no dense x was supplied to pack it from")
        else:
            if x_host is None:
                x_host = host(x)
            x_bcsr = pack_blockcsr(x_host[task.i * tm:(task.i + 1) * tm, :],
                                   block, eps=eps, device=y.device)
        mi = part.row_extent(task.i)
        ys = y[:, task.j * tn:(task.j + 1) * tn]
        if task.primitive == "SpMM":
            if y_host is None:
                y_host = host(y)
            y_bcsr = pack_blockcsr(y_host[:, task.j * tn:(task.j + 1) * tn],
                                   block, eps=eps, device=y.device)
            tile = ops.spmm(x_bcsr, y_bcsr)
        else:
            tile = ops.spdmm(x_bcsr, ys)
        z[task.i * tm:task.i * tm + mi,
          task.j * tn:task.j * tn + ys.shape[1]] = tile
    return z


def _execute_batched(part, stq, dtq, x, y, *, block, packed=None, eps=0.0):
    """Per-queue fused dispatch with in-place output assembly.

    ONE ``(M_pad, N_pad)`` canvas holds the final padded layout of the
    partition: row-stripe ``i`` occupies rows ``[i*SM, (i+1)*SM)`` and
    col-stripe ``j`` columns ``[j*SN, (j+1)*SN)``.  Each fused kernel
    scatters its tasks' tiles directly into that canvas in place, so blocks
    a primitive doesn't touch keep what the previous primitive (or the zero
    init) left there.  Assembly is ``canvas[:M, :N]``.
    """
    tm, tn = part.tile_m, part.tile_n
    M, K, N = part.M, part.K, part.N
    nrt, nct = part.n_row_tiles, part.n_col_tiles
    B = block

    # The canvas is addressed in units of B-blocks (sparse kernels) and
    # 8-lane groups (GEMM tiles), so every interior slot boundary must be a
    # multiple of lcm(B, 8); other geometries take the equivalent per-task
    # path (which reuses the packed stripes, so x=None still works there).
    slots = _dispatch.canvas_slots(part, B)
    if slots is None:
        return _execute_pertask(part, stq, dtq, x, y, block=B, eps=eps,
                                packed=packed)
    SM, SN = slots
    R = SM // B                      # block-rows per row-stripe slot
    C = SN // B                      # block-cols per col-stripe slot
    M_pad, N_pad = nrt * SM, nct * SN
    dev = y.device
    z = torch.zeros((M_pad, N_pad), dtype=torch.float32, device=dev)

    spdmm_tasks = [t for t in stq if t.primitive != "SpMM"]
    spmm_tasks = [t for t in stq if t.primitive == "SpMM"]

    # pack (or fetch) the BlockCSR row-stripes the sparse queue needs
    stripes: dict[int, BlockCSR] = {}
    for i in sorted({t.i for t in spdmm_tasks} | {t.i for t in spmm_tasks}):
        if packed is not None and i in packed:
            stripes[i] = packed[i]
        else:
            if x is None:
                raise ValueError(
                    f"execute_plan: row-stripe {i} is missing from `packed` "
                    "and no dense x was supplied to pack it from")
            stripes[i] = pack_blockcsr(x[i * tm:(i + 1) * tm, :], B,
                                       eps=eps, device=dev)

    # ---------------- DTQ: one batched GEMM scattered into the canvas
    if dtq:
        if x is None:
            raise ValueError("execute_plan: dense-queue tasks need the "
                             "densified x operand (got x=None)")
        task_is = np.array([t.i for t in dtq], dtype=np.int32)
        task_js = np.array([t.j for t in dtq], dtype=np.int32)
        x_p = F.pad(x, (0, 0, 0, M_pad - M))
        y_p = F.pad(y, (0, nct * tn - N)).reshape(K, nct, tn)
        if SN != tn:
            y_p = F.pad(y_p, (0, SN - tn))
        xs = x_p.reshape(nrt, SM, K)[torch.as_tensor(task_is, device=dev).long()]
        ys = y_p.movedim(1, 0)[torch.as_tensor(task_js, device=dev).long()]
        z = ops.gemm_batch_scatter(xs, ys, task_is, task_js, z)

    # ---------------- STQ / SpDMM: one fused entry list
    if spdmm_tasks:
        ncb = -(-K // B)
        # Y with each col-stripe padded to SN columns, K padded to blocks
        y_pad = F.pad(y, (0, nct * tn - N, 0, ncb * B - K))
        y_f = F.pad(y_pad.reshape(ncb * B, nct, tn), (0, SN - tn)
                    ).reshape(ncb * B, nct * SN)
        offsets, a_pool = _dispatch._stripe_pool(spdmm_tasks, stripes)
        a_ids, y_rows, out_rows, out_cols, first = \
            _dispatch.spdmm_entry_arrays(spdmm_tasks, stripes, offsets, R)
        z = ops.spdmm_fused(
            a_pool, y_f, a_ids, y_rows, out_rows, out_cols, first,
            block_size=B, bn=SN, m_pad=M_pad, z=z)

    # ---------------- STQ / SpMM: one fused triple list
    if spmm_tasks:
        # ONE host pull of Y serves every col-stripe pack of this call
        y_np = host(y)
        ystripes = {
            j: pack_blockcsr(y_np[:, j * tn:(j + 1) * tn], B, eps=eps,
                             device=dev)
            for j in sorted({t.j for t in spmm_tasks})}
        a_off: dict[int, int] = {}
        y_off: dict[int, int] = {}
        a_pool, y_pool = [], []
        off = 0
        for i in sorted({t.i for t in spmm_tasks}):
            a_off[i] = off
            a_pool.append(stripes[i].blocks[: stripes[i].nnzb])
            off += stripes[i].nnzb
        a_sent = off
        off = 0
        for j in sorted(ystripes):
            y_off[j] = off
            y_pool.append(ystripes[j].blocks[: ystripes[j].nnzb])
            off += ystripes[j].nnzb
        y_sent = off
        a_blocks = torch.cat(a_pool + [torch.zeros_like(a_pool[0][:1])])
        y_blocks = torch.cat(y_pool + [torch.zeros_like(y_pool[0][:1])])

        trip = []  # (out_row, out_col, a_id, y_id), per-task canvas regions
        for task in spmm_tasks:
            trip.extend(pair_block_triples(
                stripes[task.i], ystripes[task.j],
                a_sentinel=a_sent, y_sentinel=y_sent,
                a_offset=a_off[task.i], y_offset=y_off[task.j],
                base_row=task.i * R, base_col=task.j * C,
                n_row_blocks=-(-part.row_extent(task.i) // B),
                n_col_blocks=-(-part.col_extent(task.j) // B)))
        trip.sort()
        out_rows = np.array([t[0] for t in trip], dtype=np.int32)
        out_cols = np.array([t[1] for t in trip], dtype=np.int32)
        z = ops.spmm_fused(
            a_blocks, y_blocks,
            np.array([t[2] for t in trip], dtype=np.int32),
            np.array([t[3] for t in trip], dtype=np.int32),
            out_rows, out_cols, first_visit_flags(out_rows, out_cols),
            block_size=B, m_pad=M_pad, n_pad=N_pad, z=z)

    return z[:M, :N]
