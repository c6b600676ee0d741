"""Public wrappers around the kernels.

The wrapper-call counter, the per-kernel count of real CUDA launches, and
the reference wrappers' shape rules (``repro/kernels/ops.py``) where the
kernels need them.  Each wrapper dispatches on its operands' device: CPU
tensors run the plain PyTorch version, CUDA tensors launch the hand-written
kernel.  The canvas ``z`` of the fused kernels is updated IN PLACE (the TPU
kernels alias it to their output).

The fused sparse kernels and the batched GEMMs take float32 operands; a
bfloat16 operand is widened to float32 here, which is exact and equals the
reference's ``jnp.dot(bf16, f32)`` promotion.  ``pred=(flag, when)``
predicates a launch on a device flag (see
:func:`repro_torch.kernels.gemm.gemm`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import spdmm as _spdmm
from repro_torch.kernels import spmm as _spmm
from repro_torch.kernels.formats import BlockCSR, block_nonzero_mask

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


def _i32(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.device != device:
            raise ValueError(f"descriptor on {a.device}, expected {device}")
        return a.to(torch.int32).contiguous()
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """float32 contiguous view or copy (bfloat16 widens exactly)."""
    return t.float().contiguous()


def _f32_rows(t: torch.Tensor) -> torch.Tensor:
    """float32 matrix at its own row stride: copied only to widen it or to
    make its columns adjacent."""
    t = t.float()
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def gemm(x, y, *, out_dtype=None, pred=None):
    """Dense ``x @ y`` through the tiled GEMM kernel, float32 accumulation,
    cast to ``out_dtype`` (default: ``x``'s dtype, as the reference).

    The reference pads x and y to its MXU block multiples and slices the
    result; the kernel masks its own tails, so no padded copy is made and
    there are no block sizes to choose.  A float32/bfloat16 mixed pair is
    widened to float32 (exact)."""
    out_dtype = out_dtype or x.dtype
    if x.dtype != y.dtype:
        x, y = x.float(), y.float()
    _count_call()
    return _gemm.gemm(x.contiguous(), y.contiguous(), out_dtype=out_dtype,
                      pred=pred)


def gemm_batch(x, y, *, out_dtype=torch.float32):
    """Batched tile GEMM ``z[t] = x[t] @ y[t]`` in one launch; ``x`` is
    ``(T, m, k)``, ``y`` ``(T, k, n)``.  The kernel masks its own tails, so
    the reference's lane padding is not copied in; the result is
    ``(T, m, n)`` in ``out_dtype``."""
    _count_call()
    return _gemm.gemm_batch(_f32(x), _f32(y)).to(out_dtype)


def gemm_batch_scatter(x, y, rows, cols, z, *, bk: int = 128, pred=None):
    """Batched tile GEMM scattered in place: ``z`` at tile coords
    ``(rows[t], cols[t])`` receives ``x[t] @ y[t]``; other tiles keep their
    content.  Returns ``z``, updated in place.

    The reference wrapper zero-pads K to a multiple of
    ``min(bk, round_up(k, 8))``; here x and y reach the kernel at the
    caller's k, with no padded copy.  The kernel masks its own K tail, and
    a zero term adds +0 to a sum that starts at +0, so the result is
    bit-identical to the padded call.  ``bk`` is kept for the reference's
    signature and changes nothing."""
    _count_call()
    return _gemm.gemm_batch_scatter(_f32(x), _f32(y), _i32(rows, z.device),
                                    _i32(cols, z.device), z, pred=pred)


def spdmm(a: BlockCSR, y, *, out_dtype=torch.float32):
    """Block-sparse ``a @ y`` through the single-BlockCSR SpDMM kernel.
    Y's rows are zero-padded to the block multiple the kernel reads; the
    reference also pads Y's columns to its ``bn`` stripes, which the kernel
    does not need (one launch covers the whole width).  Returns the logical
    ``(M, N)`` product in ``out_dtype``."""
    m, k = a.shape
    k2, n = y.shape
    assert k == k2, (a.shape, y.shape)
    kp = a.n_block_cols * a.block_size
    if a.blocks.dtype != torch.float32:
        a = dataclasses.replace(a, blocks=_f32(a.blocks))
    _count_call()
    out = _spdmm.spdmm(a, _f32(F.pad(y, (0, 0, 0, kp - k))))
    return out[:m, :n].to(out_dtype)


def spdmm_fused(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, *,
                block_size: int, bn: int, m_pad: int, z=None, pred=None):
    """Fused multi-task SpDMM over a concatenated stored-block pool; see
    :func:`repro_torch.kernels.spdmm.spdmm_fused`.  ``y`` ``(K, N)`` is read
    where it lies, at its row stride; its ``bn``-wide col-stripes are the
    ones the entries address, the last one clipped to N.  ``z`` ``(m_pad,
    N)`` is the canvas, updated in place (a zero canvas is allocated when
    not given); uncovered blocks keep its content.  ``m_pad`` need not be a
    block multiple: rows past it are not written."""
    dev = y.device
    if z is None:
        z = torch.zeros((m_pad, y.shape[1]), dtype=torch.float32, device=dev)
    assert z.shape == (m_pad, y.shape[1]), (z.shape, m_pad, y.shape)
    _count_call()
    return _spdmm.spdmm_fused(
        _f32(a_blocks), _f32_rows(y), _i32(a_ids, dev),
        _i32(y_rows, dev), _i32(out_rows, dev), _i32(out_cols, dev),
        _i32(first, dev),
        block_size=block_size, bn=bn, z=z, pred=pred)


def spmm(a: BlockCSR, y: BlockCSR, *, out_dtype=torch.float32):
    """Block-sparse ``a @ y`` with both operands BlockCSR, through the fused
    SpMM kernel (see :func:`repro_torch.kernels.spmm.spmm`); returns the
    logical ``(M, N)`` product in ``out_dtype``."""
    m, n = a.shape[0], y.shape[1]
    _count_call()
    return _spmm.spmm(a, y)[:m, :n].to(out_dtype)


def spmm_fused(a_blocks, y_blocks, a_ids, y_ids, out_rows, out_cols, first, *,
               block_size: int, m_pad: int, n_pad: int, z=None, pred=None):
    """Fused multi-task SpMM over concatenated block pools; see
    :func:`repro_torch.kernels.spmm.spmm_fused`.  ``z`` is the canvas,
    updated in place (a zero canvas is allocated when not given)."""
    dev = y_blocks.device
    if z is None:
        z = torch.zeros((m_pad, n_pad), dtype=torch.float32, device=dev)
    assert z.shape == (m_pad, n_pad), (z.shape, m_pad, n_pad)
    _count_call()
    return _spmm.spmm_fused(
        _f32(a_blocks), _f32(y_blocks), _i32(a_ids, dev),
        _i32(y_ids, dev), _i32(out_rows, dev), _i32(out_cols, dev),
        _i32(first, dev),
        block_size=block_size, z=z, pred=pred)


def blockize(y: torch.Tensor, block: int) -> torch.Tensor:
    """Dense ``(R*B, C*B)`` matrix → ``(R*C, B, B)`` block pool in row-major
    block order (``pool[r*C + c] == y[r*B:(r+1)*B, c*B:(c+1)*B]``)."""
    m, n = y.shape
    assert m % block == 0 and n % block == 0, (y.shape, block)
    r, c = m // block, n // block
    return y.reshape(r, block, c, block).permute(0, 2, 1, 3).reshape(
        r * c, block, block)


def pack_activation_stripes(x, *, block: int, n_stripes: int, slot_rows: int,
                            n_block_cols: int, capacity, eps: float = 0.0,
                            caps: torch.Tensor | None = None):
    """Capacity-padded BlockCSR packing of a dense activation ON ITS DEVICE,
    with fixed shapes and no host read of any tensor, so one captured
    program serves any activation sparsity within the stored-block budget.

    ``x`` is the dense ``(M, K)`` operand; ``capacity`` is a static int
    (every stripe gets the same budget) or a static per-stripe vector of
    ``n_stripes`` ints (stripes packed back to back at flat offsets
    ``cumsum(capacity)``); ``caps``, when given, is the same budget vector
    already on ``x``'s device (a captured program cannot upload it).  Each
    of the ``n_stripes`` canvas row-stripes (``slot_rows`` block-rows tall)
    is packed into exactly its budgeted number of block slots:

    - stored blocks (any ``|elem| > eps``; ``!= 0`` when ``eps == 0``) fill
      slots in row-major (block-row, block-col) order — the order
      ``pack_blockcsr`` emits;
    - block-rows with no stored block keep one zero block at column 0 with
      ``first = 1`` (output-init coverage), including the canvas padding
      rows past the logical extent;
    - remaining slots are capacity padding: a zero block at the LAST
      block-row, column 0, ``first = 0`` — exact bitwise no-ops.

    Returns ``(blocks, row_ids, col_ids, first, nnzb, real, overflow)``:
    the pooled ``(sum(capacity), B, B)`` slot payloads in ``x``'s dtype,
    the flat per-slot metadata (int32), the per-stripe slot counts (stored
    blocks + empty-row fillers — what the budget must cover), the
    per-stripe count of REAL stored blocks (fillers excluded), and a 0-dim
    bool that is True when ANY stripe needs more than its budget (blocks
    past the budget are dropped — the caller takes its dense fallback).
    Slot targets are scattered into a pool of ``total + 1`` slots whose
    last slot absorbs every non-stored and over-budget block and is then
    dropped (torch has no ``mode="drop"`` scatter)."""
    B, S, R, C = block, n_stripes, slot_rows, n_block_cols
    cap_np = np.asarray(capacity, dtype=np.int64)
    if cap_np.ndim == 0:
        cap_np = np.full(S, int(cap_np), dtype=np.int64)
    assert cap_np.shape == (S,), (cap_np.shape, S)
    total = int(cap_np.sum())
    dev = x.device
    M, K = x.shape
    xp = F.pad(x, (0, C * B - K, 0, S * R * B - M))
    xb = xp.reshape(S, R, B, C, B).permute(0, 1, 3, 2, 4)   # (S,R,C,B,B)
    mask = block_nonzero_mask(xb, eps, axis=(-2, -1), xp=torch)   # (S,R,C)
    row_has = mask.any(dim=2)                                 # (S, R)
    col0 = torch.arange(C, device=dev) == 0
    stored = mask | ((~row_has)[:, :, None] & col0)
    first = stored & (torch.cumsum(stored, dim=2) == 1)

    flat = stored.reshape(S, R * C)
    cnt = torch.cumsum(flat, dim=1, dtype=torch.int32)
    slot = cnt - 1
    nnzb = cnt[:, -1]
    # filler/padding slots carry EXACT zero blocks (torch.where, not a mask
    # multiply: ``-x * 0 == -0.0`` would leak signed zeros into the pool)
    blocks = torch.where(mask[..., None, None], xb,
                         torch.zeros((), dtype=x.dtype, device=dev))
    r_idx = torch.arange(R, dtype=torch.int32, device=dev)[None, :, None]
    c_idx = torch.arange(C, dtype=torch.int32, device=dev)[None, None, :]
    if caps is None:
        caps = (torch.full((S,), int(cap_np[0]), dtype=torch.int32,
                           device=dev)
                if (cap_np == cap_np[0]).all() else
                torch.as_tensor(cap_np.astype(np.int32), device=dev))
    caps_j = caps.reshape(S, 1)
    offs_j = torch.cumsum(caps_j, dim=0, dtype=torch.int32) - caps_j
    tgt = torch.where(flat & (slot < caps_j), offs_j + slot,
                      torch.full((), total, dtype=torch.int32, device=dev)
                      ).reshape(-1).long()

    def scatter(fill, values, dtype, shape=()):
        out = torch.full((total + 1,) + shape, fill, dtype=dtype, device=dev)
        return out.index_copy_(0, tgt, values)[:total]

    pool = scatter(0, blocks.reshape(S * R * C, B, B), x.dtype, (B, B))
    row_ids = scatter(R - 1, r_idx.expand(S, R, C).reshape(-1), torch.int32)
    col_ids = scatter(0, c_idx.expand(S, R, C).reshape(-1), torch.int32)
    first_f = scatter(0, first.reshape(-1).to(torch.int32), torch.int32)
    real = mask.sum(dim=(1, 2), dtype=torch.int32)
    return (pool, row_ids, col_ids, first_f, nnzb, real,
            (nnzb > caps).any())


__all__ = [
    "gemm", "gemm_batch", "gemm_batch_scatter", "spdmm", "spdmm_fused",
    "spmm", "spmm_fused", "blockize", "pack_activation_stripes",
    "kernel_call_count", "reset_kernel_call_count",
    "cuda_launch_counts", "reset_cuda_launch_counts",
]
