"""Public wrappers around the fused kernels.

Same padding rules as the reference wrappers (``repro/kernels/ops.py``), the
wrapper-call counter, and the per-kernel count of real CUDA launches.  Each
wrapper dispatches on the canvas's device: CPU tensors run the plain PyTorch
version, CUDA tensors launch the hand-written kernel.  The canvas ``z`` is
updated IN PLACE (the TPU kernels alias it to their output).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import spdmm as _spdmm
from repro_torch.kernels import spmm as _spmm

# Wrapper-call accounting: every public wrapper call bumps this counter once
# (plain or kernel), the reference's ``pallas_call_count`` rule, so tests can
# compare launch structure with the reference package call for call.
_KERNEL_CALLS = 0


def _count_call() -> None:
    global _KERNEL_CALLS
    _KERNEL_CALLS += 1


def kernel_call_count() -> int:
    return _KERNEL_CALLS


def reset_kernel_call_count() -> None:
    global _KERNEL_CALLS
    _KERNEL_CALLS = 0


def cuda_launch_counts() -> dict[str, int]:
    """Real CUDA launches per kernel name since the last reset."""
    return dict(_build.LAUNCHES)


def reset_cuda_launch_counts() -> None:
    _build.LAUNCHES.clear()


def _round_up(x: int, b: int) -> int:
    return -(-x // b) * b


def _i32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.device != device:
            raise ValueError(f"descriptor on {a.device}, expected {device}")
        return a.to(torch.int32).contiguous()
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def gemm_batch_scatter(x, y, rows, cols, z, *, bk: int = 128):
    """Batched tile GEMM scattered in place: ``z`` at tile coords
    ``(rows[t], cols[t])`` receives ``x[t] @ y[t]``; other tiles keep their
    content.  K is zero-padded to a multiple of ``min(bk, round_up(k, 8))``
    as the reference wrapper does (the kernel also masks its own K tail).
    Returns ``z``, updated in place."""
    t, m, k = x.shape
    t2, k2, n = y.shape
    assert t == t2 and k == k2, (x.shape, y.shape)
    bk_ = min(bk, _round_up(k, 8))
    kp = _round_up(k, bk_)
    if kp != k:
        x = F.pad(x, (0, kp - k))
        y = F.pad(y, (0, 0, 0, kp - k))
    _count_call()
    return _gemm.gemm_batch_scatter(x.contiguous(), y.contiguous(),
                                    _i32(rows, z.device),
                                    _i32(cols, z.device), z)


def spdmm_fused(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, *,
                block_size: int, bn: int, m_pad: int, z=None, runs=None):
    """Fused multi-task SpDMM over a concatenated stored-block pool; see
    :func:`repro_torch.kernels.spdmm.spdmm_fused`.  ``y`` must already be
    laid out with ``bn``-padded col-stripes.  ``z`` is the canvas, updated in
    place (a zero canvas is allocated when not given); uncovered blocks keep
    its content."""
    dev = y.device
    if z is None:
        z = torch.zeros((m_pad, y.shape[1]), dtype=torch.float32, device=dev)
    assert z.shape == (m_pad, y.shape[1]), (z.shape, m_pad, y.shape)
    _count_call()
    return _spdmm.spdmm_fused(
        a_blocks.contiguous(), y.contiguous(), _i32(a_ids, dev),
        _i32(y_rows, dev), _i32(out_rows, dev), _i32(out_cols, dev),
        _i32(first, dev),
        block_size=block_size, bn=bn, z=z, runs=runs)


def spmm_fused(a_blocks, y_blocks, a_ids, y_ids, out_rows, out_cols, first, *,
               block_size: int, m_pad: int, n_pad: int, z=None, runs=None):
    """Fused multi-task SpMM over concatenated block pools; see
    :func:`repro_torch.kernels.spmm.spmm_fused`.  ``z`` is the canvas,
    updated in place (a zero canvas is allocated when not given)."""
    dev = y_blocks.device
    if z is None:
        z = torch.zeros((m_pad, n_pad), dtype=torch.float32, device=dev)
    assert z.shape == (m_pad, n_pad), (z.shape, m_pad, n_pad)
    _count_call()
    return _spmm.spmm_fused(
        a_blocks.contiguous(), y_blocks.contiguous(), _i32(a_ids, dev),
        _i32(y_ids, dev), _i32(out_rows, dev), _i32(out_cols, dev),
        _i32(first, dev),
        block_size=block_size, z=z, runs=runs)


def blockize(y: torch.Tensor, block: int) -> torch.Tensor:
    """Dense ``(R*B, C*B)`` matrix → ``(R*C, B, B)`` block pool in row-major
    block order (``pool[r*C + c] == y[r*B:(r+1)*B, c*B:(c+1)*B]``)."""
    m, n = y.shape
    assert m % block == 0 and n % block == 0, (y.shape, block)
    r, c = m // block, n // block
    return y.reshape(r, block, c, block).permute(0, 2, 1, 3).reshape(
        r * c, block, block)


__all__ = [
    "gemm_batch_scatter", "spdmm_fused", "spmm_fused", "blockize",
    "kernel_call_count", "reset_kernel_call_count",
    "cuda_launch_counts", "reset_cuda_launch_counts",
]
