"""Dense GEMM kernels: the tiled ``gemm``, the stacked ``gemm_batch`` and
the Dense Task Queue's ``gemm_batch_scatter`` (in place on a canvas).

Each launches its hand-written CUDA kernel of ``csrc/gemm.cu`` for CUDA
tensors (all three on the register-blocked tiles of ``csrc/sgemm_sm90.cuh``
through one body) and runs its ``_plain`` version for CPU tensors.  The
TPU scatter kernel aliases the canvas to its output; here the kernel
updates the canvas ``z`` IN PLACE and the wrapper returns that same
tensor.

Numerics.  The kernels sum every output element with ``fmaf`` over k in
increasing order from 0; the plain versions (:func:`ordered_matmul`) sum in
the same order with a separately rounded multiply and add.  Each family is
therefore independent of how the work is tiled: a tile of the batched
kernel equals the dense kernel's result on the same rows bit for bit, on
the card among the kernels and on the CPU among the plain versions, which
is what lets the per-task, batched and compiled routes agree bitwise.
Kernel and plain version differ in rounding (one fused vs two rounded
operations) and agree within a float32 tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ordered_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` in float32, each element summed over k in increasing order
    from 0 (``acc = acc + x[..., :, k] * y[..., k, :]``), batched over
    leading dims.  Elementwise operations round each element on its own,
    so the result of an element does not depend on the shapes around it."""
    xf, yf = x.float(), y.float()
    acc = torch.zeros(xf.shape[:-1] + yf.shape[-1:], dtype=torch.float32,
                      device=xf.device)
    for k in range(xf.shape[-1]):
        acc.add_(xf[..., :, k:k + 1] * yf[..., k:k + 1, :])
    return acc


def _same_device(*ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


# ------------------------------------------------------------------ gemm
def gemm(x: torch.Tensor, y: torch.Tensor, *, out_dtype=torch.float32,
         pred=None) -> torch.Tensor:
    """``x @ y`` for ``x`` ``(M, K)``, ``y`` ``(K, N)``, accumulated in
    float32 and cast to ``out_dtype`` (float32 or bfloat16).  Inputs are
    float32 or bfloat16, both of one type (the ``ops`` wrapper widens a
    mixed pair).  Any shape: the kernel masks its own tails and picks its
    tile from N.

    ``pred`` (CUDA only) is ``(flag, when)``: the kernel's thread blocks
    return at once unless the one-element int32 device ``flag`` equals
    ``when``, and the output is then left unwritten.  CPU tensors run the
    plain version; CUDA tensors launch the kernel (or raise)."""
    m, k = x.shape
    k2, n = y.shape
    _build.require(k == k2, f"x {tuple(x.shape)} vs y {tuple(y.shape)}")
    _same_device(x, y)
    if x.device.type == "cpu":
        return gemm_plain(x, y, out_dtype=out_dtype)
    for name, t in (("x", x), ("y", y)):
        _build.require(t.dtype in _DTYPE_CODE,
                       f"{name} has dtype {t.dtype}, expected float32 or "
                       "bfloat16")
        _build.check_operand(name, t, x.dtype, 2)
    _build.require(out_dtype in _DTYPE_CODE, f"out_dtype {out_dtype}")
    z = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return z
    pred_ptr, when = _build.predicate(pred)
    err = _build.library().gemm_tiled(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), m, k, n,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], pred_ptr, when,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gemm")
    _build.count_launch("gemm")
    return z


def gemm_plain(x, y, *, out_dtype=torch.float32, pred=None):
    """Plain PyTorch version of :func:`gemm` (``pred`` is ignored: the
    plain version always computes)."""
    return ordered_matmul(x, y).to(out_dtype)


# ------------------------------------------------------------ gemm_batch
def gemm_batch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Stacked ``z[t] = x[t] @ y[t]`` for ``x`` ``(T, m, k)``, ``y``
    ``(T, k, n)``, float32 in and out.  CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    t, m, k = x.shape
    t2, k2, n = y.shape
    _build.require(t == t2 and k == k2, f"x {x.shape} vs y {y.shape}")
    _same_device(x, y)
    if x.device.type == "cpu":
        return gemm_batch_plain(x, y)
    _build.check_operand("x", x, torch.float32, 3)
    _build.check_operand("y", y, torch.float32, 3)
    z = torch.empty((t, m, n), dtype=torch.float32, device=x.device)
    if t == 0 or m == 0 or n == 0:
        return z
    err = _build.library().gemm_batch_f32(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), t, m, k, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gemm_batch")
    _build.count_launch("gemm_batch")
    return z


def gemm_batch_plain(x, y):
    """Plain PyTorch version of :func:`gemm_batch`."""
    return ordered_matmul(x, y)


# ---------------------------------------------------- gemm_batch_scatter
def _validate(x, y, rows, cols, z):
    t, m, k = x.shape
    t2, k2, n = y.shape
    _build.require(t == t2 and k == k2, f"x {x.shape} vs y {y.shape}")
    _build.require(rows.shape == (t,) and cols.shape == (t,),
                   f"rows {rows.shape} / cols {cols.shape} for {t} tasks")
    mz, nz = z.shape
    _build.require(mz % m == 0 and nz % n == 0,
                   f"canvas {z.shape} is not a grid of ({m}, {n}) tiles")
    _same_device(x, y, rows, cols, z)


def gemm_batch_scatter(x: torch.Tensor, y: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, z: torch.Tensor, *,
                       pred=None) -> torch.Tensor:
    """Task ``t`` overwrites canvas tile ``(rows[t], cols[t])`` of ``z`` —
    rows ``[rows[t]*m, +m)``, cols ``[cols[t]*n, +n)`` — with
    ``x[t] @ y[t]`` accumulated in float32; every other element of ``z`` is
    kept.  ``x`` is ``(T, m, k)``, ``y`` ``(T, k, n)``; ``z``'s dims must be
    multiples of ``(m, n)``.  ``z`` is updated in place and returned.
    ``pred`` predicates the launch as in :func:`gemm`.

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
    pred_ptr, when = _build.predicate(pred)
    err = _build.library().gemm_batch_scatter_f32(
        x.data_ptr(), y.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        z.data_ptr(), t, m, k, n, z.shape[1], pred_ptr, when,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "gemm_batch_scatter")
    _build.count_launch("gemm_batch_scatter")
    return z


def gemm_batch_scatter_plain(x, y, rows, cols, z, *, pred=None):
    """Plain PyTorch version of :func:`gemm_batch_scatter` (same in-place
    contract; ``pred`` is ignored): one ordered batched product, then one
    indexed write of the tiles."""
    _validate(x, y, rows, cols, z)
    _, m, _ = x.shape
    n = y.shape[2]
    out = ordered_matmul(x, y)
    z4 = z.view(z.shape[0] // m, m, z.shape[1] // n, n)
    z4[rows.long(), :, cols.long(), :] = out.to(z.dtype)
    return z
