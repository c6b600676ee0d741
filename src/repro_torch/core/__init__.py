"""The paper's primary contribution: dynamic sparsity-exploiting GNN
inference runtime for a heterogeneous (dense-engine + sparse-engine) target.

Pipeline: sparsity measurement -> 2-D task partitioning -> Analyzer
(perf-model queue assignment, Alg. 4) -> Scheduler (engine dispatch) ->
fused kernels (gemm_batch_scatter / spdmm_fused / spmm_fused).
"""
from repro_torch.core.engine import DynasparseEngine, EngineReport
from repro_torch.core.perfmodel import (HardwareModel, TaskShape, VCK5000,
                                        VCK5000_384, TPUV5E, t_dense,
                                        t_sparse)
from repro_torch.core.plancache import KernelPlan, PlanCache
from repro_torch.core.primitives import SparseCOO

__all__ = [
    "DynasparseEngine", "EngineReport", "HardwareModel", "TaskShape",
    "VCK5000", "VCK5000_384", "TPUV5E", "t_dense", "t_sparse", "SparseCOO",
    "KernelPlan", "PlanCache",
]
