"""Block-sparse x dense products: the fused multi-task SpDMM on an in-place
canvas (``spdmm_fused``) and the single-BlockCSR SpDMM (``spdmm``).

Each launches its hand-written CUDA kernel (``spdmm_fused_kernel``,
``spdmm_kernel``: one run walk, ``csrc/spdmm_fused.cu``) for CUDA tensors
and runs its ``_plain`` version for CPU tensors.  The TPU
fused kernel aliases the canvas to its output; here the kernel updates the
canvas ``z`` IN PLACE and the wrapper returns it.

Semantics of ``spdmm_fused`` (both versions): entries are walked in order
within each output-block run (a maximal stretch of entries with one
``(out_row, out_col)`` key).  A run's accumulator starts from the canvas
content; an entry with ``first`` set zeroes it — also in the middle of a
run — before adding ``A_pool[a_ids[t]] @ Y[y_rows[t]*B:+B,
out_cols[t]*bn:+bn]``.  Blocks no entry covers are untouched.  Each output
block must form ONE run: two runs of one block would race on the card.

``Y`` ``(K, N)`` and ``Z`` ``(M, N)`` are taken where they lie: any row
stride, columns adjacent.  Block row ``r`` and stripe ``c`` are clipped to
them: the product reads only Y's rows below K and columns below N, counts
what lies outside as zero, and writes only Z's rows below M and columns
below N.  A row at or past K is never needed: the entries' A blocks are
zero in every column past K (the packer pads them so), and the walk skips
an all-zero A column.  The padded layout (``K``, ``M`` block multiples,
``N`` a multiple of ``bn``) is the case in which nothing is clipped.

The plain versions form every entry's block product with
:func:`repro_torch.kernels.gemm.ordered_matmul` and fold them run by run
(:func:`fold_runs`), so a tile computed by ``spdmm`` and by
``spdmm_fused`` is bitwise the same on the CPU, as the two kernels' tiles
are on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.formats import BlockCSR, run_starts
from repro_torch.kernels.gemm import ordered_matmul

_DESCRIPTORS = ("a_ids", "y_rows", "out_rows", "out_cols", "first")


def fold_runs(prod, first, out_rows, out_cols, runs, z, bm: int, bn: int):
    """Plain-version core shared by the sparse kernels: fold the per-entry
    products ``prod`` ``(E, bm, bn)`` into the ``bm x bn`` canvas blocks of
    ``z`` run by run.  Each run keeps only its last ``first`` epoch (a
    ``first`` restarts the sum) and adds onto the canvas when that epoch
    opened without a ``first``.  Padding run slots (equal offsets) are
    skipped.  Updates ``z`` in place."""
    E = int(prod.shape[0])
    if E == 0:
        return z
    runs = runs.long()
    starts, ends = runs[:-1], runs[1:]
    real = ends > starts
    starts, ends = starts[real], ends[real]
    opens = first != 0
    opens[starts] = True
    epoch = torch.cumsum(opens.long(), 0) - 1
    sums = torch.zeros((int(epoch[-1]) + 1, bm, bn), dtype=torch.float32,
                       device=prod.device).index_add_(0, epoch, prod.float())
    last = epoch[ends - 1]
    opener = torch.nonzero(opens).flatten()[last]
    reset = (first[opener] != 0)[:, None, None]
    z4 = z.view(z.shape[0] // bm, bm, z.shape[1] // bn, bn)
    r, c = out_rows[starts].long(), out_cols[starts].long()
    folded = sums[last]
    z4[r, :, c, :] = torch.where(reset, folded,
                                 z4[r, :, c, :].float() + folded).to(z.dtype)
    return z


# ------------------------------------------------------------ spdmm_fused
def _validate(a_blocks, y, desc, B, bn, z):
    E = desc[0].shape[0]
    _build.require(all(d.shape == (E,) for d in desc),
                   f"descriptor shapes {[d.shape for d in desc]}")
    _build.require(a_blocks.ndim == 3 and a_blocks.shape[1:] == (B, B),
                   f"pool {a_blocks.shape} for block {B}")
    _build.require(y.ndim == 2 and z.ndim == 2 and bn >= 1,
                   f"operand {tuple(y.shape)}, canvas {tuple(z.shape)}, "
                   f"bn {bn}")
    _build.require(z.shape[1] == y.shape[1],
                   f"canvas {tuple(z.shape)} for operand {tuple(y.shape)}")
    devs = {t.device for t in (a_blocks, y, z, *desc)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def spdmm_fused(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, *,
                block_size: int, bn: int, z: torch.Tensor,
                pred=None) -> torch.Tensor:
    """Fused SpDMM into the canvas ``z`` ``(M, N)``, in place.

    ``a_blocks`` ``(P, B, B)`` is the stored-block pool; ``y`` ``(K, N)``
    the dense operand, whose ``bn``-wide col-stripes the entries address;
    ``y`` and ``z`` at any row stride, clipped as the module says.  The
    five int32 descriptor arrays are sorted by output block.  The kernel finds
    the runs itself, from the key changes of ``out_rows`` / ``out_cols``,
    so it takes no run offsets and its launch does not depend on the data
    (the compiled activation route makes its descriptors on the device).
    ``pred`` predicates
    the launch as in :func:`repro_torch.kernels.gemm.gemm`.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (or raise)."""
    B = block_size
    desc = (a_ids, y_rows, out_rows, out_cols, first)
    _validate(a_blocks, y, desc, B, bn, z)
    if z.device.type == "cpu":
        return spdmm_fused_plain(a_blocks, y, *desc, block_size=B, bn=bn,
                                 z=z)
    _build.check_operand("a_blocks", a_blocks, torch.float32, 3)
    _build.check_rows("y", y, torch.float32)
    _build.check_rows("z", z, torch.float32)
    for name, d in zip(_DESCRIPTORS, desc):
        _build.check_operand(name, d, torch.int32, 1)
    n_entries = int(a_ids.shape[0])
    if n_entries == 0:
        return z
    pred_ptr, when = _build.predicate(pred)
    err = _build.library().spdmm_fused_f32(
        a_blocks.data_ptr(), y.data_ptr(), *(d.data_ptr() for d in desc),
        n_entries, z.data_ptr(), B, bn, y.stride(0), z.stride(0),
        z.shape[0], z.shape[1], pred_ptr, when,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "spdmm_fused")
    _build.count_launch("spdmm_fused")
    return z


def spdmm_fused_plain(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first,
                      *, block_size: int, bn: int, z: torch.Tensor,
                      pred=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spdmm_fused` (same in-place
    contract; ``pred`` is ignored): find the runs
    (:func:`~repro_torch.kernels.formats.run_starts`, one host read), gather
    every entry's A block and Y slice, form the products in k order, then
    :func:`fold_runs`.  Its
    summation order differs from the kernel's, so the two agree within a
    float32 tolerance.  A ``y`` or ``z`` that is not in the padded layout
    is zero-padded to it around the fold (``z`` copied back), which is
    the clipping the module describes."""
    B = block_size
    runs = run_starts(out_rows, out_cols)
    (k, n), m = y.shape, z.shape[0]
    k_pad, m_pad, n_pad = -(-k // B) * B, -(-m // B) * B, -(-n // bn) * bn
    y_p = F.pad(y, (0, n_pad - n, 0, k_pad - k)) if (k, n) != (
        k_pad, n_pad) else y
    z_p = F.pad(z, (0, n_pad - n, 0, m_pad - m)) if (m, n) != (
        m_pad, n_pad) else z
    yb = y_p.reshape(k_pad // B, B, n_pad // bn, bn)
    ys = yb[y_rows.long(), :, out_cols.long(), :]
    prod = ordered_matmul(a_blocks[a_ids.long()], ys)
    fold_runs(prod, first, out_rows, out_cols, runs, z_p, B, bn)
    if z_p is not z:
        z.copy_(z_p[:m, :n])
    return z


# ------------------------------------------------------------------ spdmm
def spdmm(a: BlockCSR, y: torch.Tensor) -> torch.Tensor:
    """``a @ y`` for a BlockCSR ``a`` and a dense float32 ``y`` ``(K_pad,
    N)`` with ``K_pad = a.n_block_cols * B``; returns the float32 ``(m_pad,
    N)`` product, ``m_pad = a.n_block_rows * B`` (the caller slices).  Every
    block-row holds a stored block, so every output row is written.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    B = a.block_size
    k_pad, n = y.shape
    _build.require(k_pad == a.n_block_cols * B,
                   f"operand {tuple(y.shape)} for {a.shape} at block {B}")
    if a.blocks.device != y.device:
        raise ValueError(f"operands on {a.blocks.device} and {y.device}")
    if y.device.type == "cpu":
        return spdmm_plain(a, y)
    for name, t, dt, nd in (("blocks", a.blocks, torch.float32, 3),
                            ("y", y, torch.float32, 2),
                            ("row_ids", a.row_ids, torch.int32, 1),
                            ("col_ids", a.col_ids, torch.int32, 1),
                            ("first", a.first, torch.int32, 1)):
        _build.check_operand(name, t, dt, nd)
    z = torch.zeros((a.n_block_rows * B, n), dtype=torch.float32,
                    device=y.device)
    if a.stored_blocks == 0 or n == 0:
        return z
    err = _build.library().spdmm_f32(
        a.blocks.data_ptr(), y.data_ptr(), a.row_ids.data_ptr(),
        a.col_ids.data_ptr(), a.first.data_ptr(), a.stored_blocks,
        z.data_ptr(), B, z.shape[0], n,
        torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "spdmm")
    _build.count_launch("spdmm")
    return z


def spdmm_plain(a: BlockCSR, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spdmm`: the BlockCSR's own entry
    list (``a_ids = t``, ``y_rows = col_ids``, ``out_rows = row_ids``) over
    the whole width of ``y`` through :func:`spdmm_fused_plain`."""
    B = a.block_size
    n = y.shape[1]
    z = torch.zeros((a.n_block_rows * B, n), dtype=torch.float32,
                    device=y.device)
    if n == 0 or a.stored_blocks == 0:
        return z
    ids = torch.arange(a.stored_blocks, dtype=torch.int32,
                       device=a.row_ids.device)
    return spdmm_fused_plain(
        a.blocks, y, ids, a.col_ids, a.row_ids,
        torch.zeros_like(a.row_ids), a.first, block_size=B, bn=n, z=z)
