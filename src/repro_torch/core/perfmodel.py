"""Analytical performance model — paper Table I, parameterized per platform.

Two parameter sets ship:

- ``VCK5000`` reproduces the paper's numbers (f_AIE = 1 GHz, 32 AIE CCs x 4
  tiles, β = 8 MACs/cycle/tile; f_PL = 297 MHz, 8 ALU arrays with p = 8,
  q = 4; DDR 102.4 GB/s).  Used by the benchmark harness for Tables VI-VIII.
- ``TPUV5E`` re-parameterizes the same closed forms for the TPU target
  (MXU 197 TFLOP/s bf16 dense path; the sparse path skips zero *blocks*, so
  its α is block density and its per-MAC rate is the MXU rate discounted by a
  per-block dispatch overhead).  Used by the runtime to choose dense vs
  sparse dispatch on TPU.  **These constants are UNCALIBRATED fallback
  defaults** — the 0.85/0.70 block-skip efficiencies and the ~100 ns
  dispatch bubble are hand-tuned guesses, which is why the model is marked
  ``fallback=True``: a runtime engine is expected to replace them with a
  measured model before trusting its STQ/DTQ decisions
  (:mod:`repro_torch.core.calibrate`).  ``VCK5000`` stays analytical by
  design — it reproduces the paper's tables.

Closed forms (Table I):
    t_AIE   = m·n·d / (f_AIE · N_AIE · β)
    t_SpDMM = α_min · m·n·d / (f_PL · p·q)          [per ALU array]
    t_SpMM  = α_X · α_Y · m·n·d / (f_PL · p)        [per ALU array]
    t_ALU   = min(t_SpDMM, t_SpMM)
plus a memory term ``bytes / mem_bw`` (the paper's Ramulator-backed DDR
model reduced to a bandwidth bound): task time = max(compute, memory).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Primitive = Literal["GEMM", "SpDMM", "SpMM"]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    name: str
    # dense engine (AIE array / MXU)
    f_dense: float            # Hz
    dense_macs_per_cycle: float   # N_AIE * beta  (whole dense engine)
    # sparse engine (one ALU array / block-skip kernel path)
    f_sparse: float           # Hz
    spdmm_macs_per_cycle: float   # p*q per sparse unit
    spmm_macs_per_cycle: float    # p per sparse unit
    n_sparse_units: int       # ALU arrays
    mem_bw: float             # bytes/s (DDR / HBM)
    bytes_per_elem: int = 4   # fp32 on VCK5000; bf16 = 2 on TPU
    # fixed per-task dispatch overhead (s) — runtime system + DMA setup
    dispatch_overhead: float = 0.0
    # TPU block-skip granularity (element-level on VCK5000 → block=1)
    skip_block: int = 1
    # provenance: ``fallback=True`` marks hand-tuned guess constants that a
    # runtime engine should replace with a measured ``CalibratedModel``
    # when calibration is available; ``calibrated``
    # is set by the calibration subsystem on fitted models.
    fallback: bool = False
    calibrated: bool = False


# 32 AIE computation cores x 4 tiles = 128 tiles; beta = 8 MACs/cycle (fp32)
VCK5000 = HardwareModel(
    name="VCK5000",
    f_dense=1e9,
    dense_macs_per_cycle=128 * 8,
    f_sparse=297e6,
    spdmm_macs_per_cycle=8 * 4,
    spmm_macs_per_cycle=8,
    n_sparse_units=8,
    mem_bw=102.4e9,
    bytes_per_elem=4,
    dispatch_overhead=0.0,
    skip_block=1,
)

# Doubled-AIE scenario of Table VIII (384 of 400 tiles; memory unconstrained
# per the paper's assumption is handled by the caller scaling mem_bw).
VCK5000_384 = dataclasses.replace(
    VCK5000, name="VCK5000-384", dense_macs_per_cycle=256 * 8)

# TPU v5e: 197 TFLOP/s bf16 = 98.5e12 MAC/s on the dense path.  The sparse
# path is the block-skip Pallas kernel: same MXU rate on stored blocks, α is
# block density, and each stored block pays a dispatch bubble (~100 ns:
# scalar-prefetch DMA start + grid step overheads).
#
# UNCALIBRATED FALLBACK: the 0.85/0.70 efficiency discounts and the 1e-7 s
# dispatch overhead were never measured — they are plausibility guesses.
# ``fallback=True`` marks the model for replacement by a measured one so the
# Analyzer's STQ/DTQ mapping follows measured kernel timings.
TPUV5E = HardwareModel(
    name="TPUv5e",
    f_dense=940e6,
    dense_macs_per_cycle=98.5e12 / 940e6,
    f_sparse=940e6,
    spdmm_macs_per_cycle=98.5e12 / 940e6 * 0.85,   # block-skip path efficiency
    spmm_macs_per_cycle=98.5e12 / 940e6 * 0.70,
    n_sparse_units=1,
    mem_bw=819e9,
    bytes_per_elem=2,
    dispatch_overhead=1e-7,
    skip_block=128,
    fallback=True,
)


# H100 SXM (NVIDIA data sheet): 67 TFLOP/s FP32 outside the tensor cores
# (the port's kernels are FP32 FMA on the CUDA cores, 2 FLOP per MAC),
# 3.35 TB/s HBM3, 1.98 GHz boost clock.  Data-sheet starting guesses for
# that card, not measurements: the same block-skip discounts and dispatch
# bubble as the TPU guesses, float32 operands, the engine's 8 x 8 skip
# block, and ``fallback=True`` so the runtime replaces them with a measured
# ``CalibratedModel``.
_H100_MACS = 67e12 / 2
H100_FALLBACK = HardwareModel(
    name="cuda-fallback",
    f_dense=1.98e9,
    dense_macs_per_cycle=_H100_MACS / 1.98e9,
    f_sparse=1.98e9,
    spdmm_macs_per_cycle=_H100_MACS / 1.98e9 * 0.85,
    spmm_macs_per_cycle=_H100_MACS / 1.98e9 * 0.70,
    n_sparse_units=1,
    mem_bw=3.35e12,
    bytes_per_elem=4,
    dispatch_overhead=1e-7,
    skip_block=8,
    fallback=True,
)


def runtime_fallback(backend: str) -> HardwareModel:
    """Uncalibrated fallback model for a backend kind ("tpu", "cpu",
    "cuda", ...).  ``"cuda"`` gets the H100 data-sheet guesses above;
    every other kind is kept identical to the reference's table.

    Every returned model carries ``fallback=True`` — the constants are
    starting guesses the calibration subsystem is expected to replace.  The
    other non-TPU entries reuse the TPU closed forms with the name rebound
    so a ``CalibratedModel`` fitted on that backend is attributed honestly.
    """
    if backend == "tpu":
        return TPUV5E
    if backend == "cuda":
        return H100_FALLBACK
    return dataclasses.replace(TPUV5E, name=f"{backend}-fallback")


@dataclasses.dataclass(frozen=True)
class TaskShape:
    """One task (Eq. 3): Z_ij = X_{i,:} · Y_{:,j}, X (m,n), Y (n,d)."""
    m: int
    n: int
    d: int
    alpha_x: float   # density of X_{i,:} (element or block per hw.skip_block)
    alpha_y: float   # density of Y_{:,j}

    @property
    def macs(self) -> int:
        return self.m * self.n * self.d


def t_dense(task: TaskShape, hw: HardwareModel) -> float:
    """GEMM on the dense engine (Table I col 1) + memory bound."""
    compute = task.macs / (hw.f_dense * hw.dense_macs_per_cycle)
    bytes_moved = (task.m * task.n + task.n * task.d + task.m * task.d
                   ) * hw.bytes_per_elem
    return max(compute, bytes_moved / hw.mem_bw) + hw.dispatch_overhead


def t_spdmm(task: TaskShape, hw: HardwareModel) -> float:
    """SpDMM on ONE sparse unit (Table I col 2) + memory bound."""
    a_min = min(task.alpha_x, task.alpha_y)
    compute = a_min * task.macs / (hw.f_sparse * hw.spdmm_macs_per_cycle)
    # loads: nonzeros of sparse operand (COO: 2 indices + value ≈ 3 words,
    # or the stored blocks on TPU) + the dense operand stripe + output
    if task.alpha_x <= task.alpha_y:
        sparse_elems, dense_elems = (task.alpha_x * task.m * task.n,
                                     task.n * task.d)
    else:
        sparse_elems, dense_elems = (task.alpha_y * task.n * task.d,
                                     task.m * task.n)
    bytes_moved = (3 * sparse_elems + dense_elems + task.m * task.d
                   ) * hw.bytes_per_elem
    return max(compute, bytes_moved / hw.mem_bw) + hw.dispatch_overhead


def t_spmm(task: TaskShape, hw: HardwareModel) -> float:
    """SpMM on ONE sparse unit (Table I col 3) + memory bound."""
    compute = (task.alpha_x * task.alpha_y * task.macs
               / (hw.f_sparse * hw.spmm_macs_per_cycle))
    bytes_moved = (3 * task.alpha_x * task.m * task.n
                   + 3 * task.alpha_y * task.n * task.d
                   + task.m * task.d) * hw.bytes_per_elem
    return max(compute, bytes_moved / hw.mem_bw) + hw.dispatch_overhead


def t_sparse(task: TaskShape, hw: HardwareModel) -> tuple[float, Primitive]:
    """Best sparse-engine time and which primitive achieves it (Eq. 5)."""
    a, b = t_spdmm(task, hw), t_spmm(task, hw)
    return (a, "SpDMM") if a <= b else (b, "SpMM")


def flops(task: TaskShape, primitive: Primitive) -> float:
    """FLOPs actually executed by the chosen primitive (Table V accounting).
    2 FLOPs per MAC."""
    if primitive == "GEMM":
        return 2.0 * task.macs
    if primitive == "SpDMM":
        return 2.0 * min(task.alpha_x, task.alpha_y) * task.macs
    return 2.0 * task.alpha_x * task.alpha_y * task.macs


def data_count(task: TaskShape, primitive: Primitive) -> float:
    """Elements loaded from memory by the chosen primitive (Table V)."""
    if primitive == "GEMM":
        return float(task.m * task.n + task.n * task.d)
    if primitive == "SpDMM":
        if task.alpha_x <= task.alpha_y:
            return float(task.alpha_x * task.m * task.n + task.n * task.d)
        return float(task.alpha_y * task.n * task.d + task.m * task.n)
    return float(task.alpha_x * task.m * task.n
                 + task.alpha_y * task.n * task.d)
