"""Fused multi-task SpDMM (block-sparse pool x dense) on an in-place canvas.

``spdmm_fused`` launches the hand-written CUDA kernel
(``csrc/spdmm_fused.cu``) for CUDA tensors and runs ``spdmm_fused_plain``
for CPU tensors.  The TPU kernel aliases the canvas to its output; here the
kernel updates the canvas ``z`` IN PLACE and the wrapper returns it.

Semantics (both versions): entries are walked in order within each
output-block run (a maximal stretch of entries with one ``(out_row,
out_col)`` key).  A run's accumulator starts from the canvas content; an
entry with ``first`` set zeroes it — also in the middle of a run — before
adding ``A_pool[a_ids[t]] @ Y[y_rows[t]*B:+B, out_cols[t]*bn:+bn]``.  Blocks
no entry covers are untouched.  Each output block must form ONE run: two
runs of one block would race on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.formats import run_starts

_DESCRIPTORS = ("a_ids", "y_rows", "out_rows", "out_cols", "first")


def fold_runs(prod, first, out_rows, out_cols, runs, z, bm: int, bn: int):
    """Plain-version core shared by the fused sparse kernels: fold the
    per-entry products ``prod`` ``(E, bm, bn)`` into the ``bm x bn`` canvas
    blocks of ``z`` run by run.  Each run keeps only its last ``first``
    epoch (a ``first`` restarts the sum) and adds onto the canvas when that
    epoch opened without a ``first``.  Updates ``z`` in place."""
    E = int(prod.shape[0])
    if E == 0:
        return z
    runs = runs.long()
    starts, ends = runs[:-1], runs[1:]
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


def _validate(a_blocks, y, desc, B, bn, z, runs):
    E = desc[0].shape[0]
    _build.require(all(d.shape == (E,) for d in desc),
                   f"descriptor shapes {[d.shape for d in desc]}")
    _build.require(a_blocks.ndim == 3 and a_blocks.shape[1:] == (B, B),
                   f"pool {a_blocks.shape} for block {B}")
    k_pad, n_pad = y.shape
    _build.require(k_pad % B == 0 and n_pad % bn == 0,
                   f"operand {y.shape} for block {B}, bn {bn}")
    _build.require(z.shape[1] == n_pad and z.shape[0] % B == 0,
                   f"canvas {z.shape} for operand {y.shape}")
    devs = {t.device for t in (a_blocks, y, z, runs, *desc)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def spdmm_fused(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, *,
                block_size: int, bn: int, z: torch.Tensor,
                runs: torch.Tensor | None = None) -> torch.Tensor:
    """Fused SpDMM into the canvas ``z`` ``(m_pad, n_pad)``, in place.

    ``a_blocks`` ``(P, B, B)`` is the stored-block pool; ``y`` ``(K_pad,
    n_pad)`` the dense operand laid out in ``bn``-wide col-stripes; the five
    int32 descriptor arrays are sorted by output block.  ``runs`` are the
    run offsets of :func:`repro_torch.kernels.formats.run_starts` (computed
    here when not given).  CPU tensors run the plain version; CUDA tensors
    launch the kernel (or raise)."""
    B = block_size
    desc = (a_ids, y_rows, out_rows, out_cols, first)
    if runs is None:
        runs = run_starts(out_rows, out_cols)
    _validate(a_blocks, y, desc, B, bn, z, runs)
    if z.device.type == "cpu":
        return spdmm_fused_plain(a_blocks, y, *desc, block_size=B, bn=bn,
                                 z=z, runs=runs)
    _build.check_operand("a_blocks", a_blocks, torch.float32, 3)
    _build.check_operand("y", y, torch.float32, 2)
    _build.check_operand("z", z, torch.float32, 2)
    _build.check_operand("runs", runs, torch.int32, 1)
    for name, d in zip(_DESCRIPTORS, desc):
        _build.check_operand(name, d, torch.int32, 1)
    n_runs = int(runs.shape[0]) - 1
    if n_runs == 0:
        return z
    lib = _build.library()
    err = lib.spdmm_fused_f32(
        a_blocks.data_ptr(), y.data_ptr(), *(d.data_ptr() for d in desc),
        runs.data_ptr(), n_runs, z.data_ptr(), B, bn, y.shape[1], z.shape[1],
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "spdmm_fused")
    _build.count_launch("spdmm_fused")
    return z


def spdmm_fused_plain(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first,
                      *, block_size: int, bn: int, z: torch.Tensor,
                      runs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spdmm_fused` (same in-place
    contract): gather every entry's A block and Y slice, one batched
    product, then :func:`fold_runs`.  Its summation order differs from the
    kernel's, so the two agree within a float32 tolerance."""
    B = block_size
    if runs is None:
        runs = run_starts(out_rows, out_cols)
    k_pad, n_pad = y.shape
    yb = y.view(k_pad // B, B, n_pad // bn, bn)
    ys = yb[y_rows.long(), :, out_cols.long(), :]
    prod = torch.bmm(a_blocks[a_ids.long()].float(), ys.float())
    return fold_runs(prod, first, out_rows, out_cols, runs, z, B, bn)
