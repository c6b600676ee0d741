"""Fused multi-task SpMM (block-sparse x block-sparse) on an in-place canvas.

``spmm_fused`` launches the hand-written CUDA kernel (``csrc/spmm_fused.cu``)
for CUDA tensors and runs ``spmm_fused_plain`` for CPU tensors.  The TPU
kernel aliases the canvas to its output; here the kernel updates the canvas
``z`` IN PLACE and the wrapper returns it.  Run semantics are those of
:mod:`repro_torch.kernels.spdmm`, on ``B x B`` output blocks: each triple
adds ``A_pool[a_ids[t]] @ Y_pool[y_ids[t]]``; the kernel finds the runs
from the descriptors' key changes, so it takes no run offsets.  Sentinel
zero blocks at the end of each pool back the padding triples.

``spmm`` multiplies two BlockCSR operands through the same kernel, as the
reference's ``spmm`` reaches the same ``pallas_call`` (``_spmm_call``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.formats import BlockCSR, run_starts, spmm_triples
from repro_torch.kernels.gemm import ordered_matmul
from repro_torch.kernels.spdmm import fold_runs

_DESCRIPTORS = ("a_ids", "y_ids", "out_rows", "out_cols", "first")


def _validate(a_blocks, y_blocks, desc, B, z):
    E = desc[0].shape[0]
    _build.require(all(d.shape == (E,) for d in desc),
                   f"descriptor shapes {[d.shape for d in desc]}")
    for pool in (a_blocks, y_blocks):
        _build.require(pool.ndim == 3 and pool.shape[1:] == (B, B),
                       f"pool {pool.shape} for block {B}")
    _build.require(z.shape[0] % B == 0 and z.shape[1] % B == 0,
                   f"canvas {z.shape} for block {B}")
    devs = {t.device for t in (a_blocks, y_blocks, z, *desc)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


def spmm_fused(a_blocks, y_blocks, a_ids, y_ids, out_rows, out_cols, first,
               *, block_size: int, z: torch.Tensor, pred=None) -> torch.Tensor:
    """Fused SpMM into the canvas ``z`` ``(m_pad, n_pad)``, in place.

    ``a_blocks`` / ``y_blocks`` are ``(P, B, B)`` pools; the five int32
    descriptor arrays are sorted by output block, each output block one
    run; ``pred`` as in :func:`repro_torch.kernels.spdmm.spdmm_fused`.  CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    B = block_size
    desc = (a_ids, y_ids, out_rows, out_cols, first)
    _validate(a_blocks, y_blocks, desc, B, z)
    if z.device.type == "cpu":
        return spmm_fused_plain(a_blocks, y_blocks, *desc, block_size=B, z=z)
    _build.check_operand("a_blocks", a_blocks, torch.float32, 3)
    _build.check_operand("y_blocks", y_blocks, torch.float32, 3)
    _build.check_operand("z", z, torch.float32, 2)
    for name, d in zip(_DESCRIPTORS, desc):
        _build.check_operand(name, d, torch.int32, 1)
    n_entries = int(a_ids.shape[0])
    if n_entries == 0:
        return z
    pred_ptr, when = _build.predicate(pred)
    # scratch of the kernel's first launch: the A pool's blocks transposed,
    # their masks of non-zero columns and the Y pool's of non-zero rows
    n_a, n_y = a_blocks.shape[0], y_blocks.shape[0]
    a_cols = torch.empty_like(a_blocks)
    masks = torch.empty(n_a + n_y, dtype=torch.int32, device=z.device)
    err = _build.library().spmm_fused_f32(
        a_blocks.data_ptr(), y_blocks.data_ptr(),
        *(d.data_ptr() for d in desc), n_entries, z.data_ptr(), B,
        z.shape[1], pred_ptr, when, n_a, n_y, a_cols.data_ptr(),
        masks.data_ptr(), torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "spmm_fused")
    _build.count_launch("spmm_fused")
    return z


def spmm_fused_plain(a_blocks, y_blocks, a_ids, y_ids, out_rows, out_cols,
                     first, *, block_size: int, z: torch.Tensor,
                     pred=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_fused` (same in-place
    contract; ``pred`` is ignored): find the runs
    (:func:`~repro_torch.kernels.formats.run_starts`, one host read), gather
    both blocks of every triple, form the products in k order, then
    :func:`repro_torch.kernels.spdmm.fold_runs`."""
    B = block_size
    runs = run_starts(out_rows, out_cols)
    prod = ordered_matmul(a_blocks[a_ids.long()], y_blocks[y_ids.long()])
    return fold_runs(prod, first, out_rows, out_cols, runs, z, B, B)


def spmm(a: BlockCSR, y: BlockCSR) -> torch.Tensor:
    """``a @ y`` with both operands BlockCSR (float32 blocks): the host
    pairs the stored blocks (:func:`~repro_torch.kernels.formats.spmm_triples`,
    one sentinel pair for every output block that receives nothing) and one
    :func:`spmm_fused` launch walks the triples.  Returns the dense float32
    ``(n_block_rows(a)*B, n_block_cols(y)*B)`` product (the caller slices)."""
    B = a.block_size
    dev = a.blocks.device
    a_ids, y_ids, out_rows, out_cols, first = spmm_triples(a, y)
    up = lambda v: torch.as_tensor(v, device=dev)
    zero = torch.zeros((1, B, B), dtype=torch.float32, device=dev)
    z = torch.zeros((a.n_block_rows * B, y.n_block_cols * B),
                    dtype=torch.float32, device=dev)
    return spmm_fused(torch.cat([a.blocks.float(), zero]),
                      torch.cat([y.blocks.float(), zero]),
                      up(a_ids), up(y_ids), up(out_rows), up(out_cols),
                      up(first), block_size=B, z=z)
