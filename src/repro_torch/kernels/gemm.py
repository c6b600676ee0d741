"""Batched tile GEMM scattered in place: the Dense Task Queue's kernel.

``gemm_batch_scatter`` launches the hand-written CUDA kernel
(``csrc/gemm_batch_scatter.cu``) for CUDA tensors and runs
``gemm_batch_scatter_plain`` for CPU tensors.  The TPU kernel aliases the
canvas to its output; here the kernel updates the canvas ``z`` IN PLACE and
the wrapper returns that same tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _validate(x, y, rows, cols, z):
    t, m, k = x.shape
    t2, k2, n = y.shape
    _build.require(t == t2 and k == k2, f"x {x.shape} vs y {y.shape}")
    _build.require(rows.shape == (t,) and cols.shape == (t,),
                   f"rows {rows.shape} / cols {cols.shape} for {t} tasks")
    mz, nz = z.shape
    _build.require(mz % m == 0 and nz % n == 0,
                   f"canvas {z.shape} is not a grid of ({m}, {n}) tiles")
    devs = {a.device for a in (x, y, rows, cols, z)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def gemm_batch_scatter(x: torch.Tensor, y: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Task ``t`` overwrites canvas tile ``(rows[t], cols[t])`` of ``z`` —
    rows ``[rows[t]*m, +m)``, cols ``[cols[t]*n, +n)`` — with
    ``x[t] @ y[t]`` accumulated in float32; every other element of ``z`` is
    kept.  ``x`` is ``(T, m, k)``, ``y`` ``(T, k, n)``; ``z``'s dims must be
    multiples of ``(m, n)``.  ``z`` is updated in place and returned.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _validate(x, y, rows, cols, z)
    if z.device.type == "cpu":
        return gemm_batch_scatter_plain(x, y, rows, cols, z)
    for name, t, dt, nd in (("x", x, torch.float32, 3),
                            ("y", y, torch.float32, 3),
                            ("rows", rows, torch.int32, 1),
                            ("cols", cols, torch.int32, 1),
                            ("z", z, torch.float32, 2)):
        _build.check_operand(name, t, dt, nd)
    t, m, k = x.shape
    n = y.shape[2]
    if t == 0:
        return z
    lib = _build.library()
    err = lib.gemm_batch_scatter_f32(
        x.data_ptr(), y.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        z.data_ptr(), t, m, k, n, z.shape[0], z.shape[1],
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "gemm_batch_scatter")
    _build.count_launch("gemm_batch_scatter")
    return z


def gemm_batch_scatter_plain(x, y, rows, cols, z):
    """Plain PyTorch version of :func:`gemm_batch_scatter` (same in-place
    contract): one batched product, then one indexed write of the tiles."""
    _validate(x, y, rows, cols, z)
    _, m, _ = x.shape
    n = y.shape[2]
    out = torch.bmm(x.float(), y.float())
    z4 = z.view(z.shape[0] // m, m, z.shape[1] // n, n)
    z4[rows.long(), :, cols.long(), :] = out.to(z.dtype)
    return z
