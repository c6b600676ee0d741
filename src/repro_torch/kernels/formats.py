"""Block-sparse containers used by the fused kernels.

``BlockCSR`` stores only the nonzero ``B x B`` blocks of a matrix together
with the per-block metadata the fused kernels consume (block-row ids,
block-col ids, first-visit flags).  Packing happens on the host with numpy at
plan time, as in the reference package; the packed arrays are then uploaded
as torch tensors to the device the caller names.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import host


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def block_nonzero_mask(blocks, eps: float, *, axis, xp=np):
    """THE stored-block criterion, shared by every packer: a block is stored
    iff any element is nonzero (``eps == 0``) or any magnitude exceeds
    ``eps``.  ``axis`` selects the intra-block axes of ``blocks``; ``xp`` is
    the array namespace (``numpy`` for the host packers, ``torch`` for
    device tensors) so host- and device-side decisions never disagree."""
    hit = (blocks != 0) if eps == 0.0 else (xp.abs(blocks) > eps)
    if xp is np:
        return np.any(hit, axis=axis)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    for ax in sorted((a % hit.ndim for a in axes), reverse=True):
        hit = hit.any(dim=ax)
    return hit


@dataclasses.dataclass
class BlockCSR:
    """Block-compressed sparse row matrix over torch tensors.

    Blocks are stored sorted by (block_row, block_col).  Every block-row
    holds at least one stored block (empty rows get a single zero block at
    column 0) so the ``first`` flags initialize the whole output.  Stored
    blocks may be padded at the tail with zero blocks (``row_ids`` pointing
    at the last block-row, ``first = 0``).
    """

    shape: Tuple[int, int]          # logical (M, K)
    block_size: int                 # B
    row_ids: torch.Tensor           # (nnzb,) int32 block-row of each block
    col_ids: torch.Tensor           # (nnzb,) int32 block-col of each block
    first: torch.Tensor             # (nnzb,) int32 1 iff first block in its row
    blocks: torch.Tensor            # (nnzb, B, B)
    nnzb: int                       # number of REAL (non-padding) blocks

    @property
    def n_block_rows(self) -> int:
        return _ceil_div(self.shape[0], self.block_size)

    @property
    def n_block_cols(self) -> int:
        return _ceil_div(self.shape[1], self.block_size)

    @property
    def stored_blocks(self) -> int:
        return int(self.blocks.shape[0])

    def block_density(self) -> float:
        return self.nnzb / max(1, self.n_block_rows * self.n_block_cols)

    def todense(self) -> torch.Tensor:
        """Dense reconstruction (host/oracle use), on the blocks' device."""
        B = self.block_size
        M = self.n_block_rows * B
        K = self.n_block_cols * B
        blocks = host(self.blocks)
        out = np.zeros((M, K), dtype=blocks.dtype)
        for r, c, blk in zip(host(self.row_ids), host(self.col_ids), blocks):
            out[r * B:(r + 1) * B, c * B:(c + 1) * B] += blk
        dense = torch.as_tensor(out, device=self.blocks.device)
        return dense[: self.shape[0], : self.shape[1]]


def _make(shape, B, rows, cols, first, blocks, nnzb, dtype, device):
    blocks_t = torch.as_tensor(np.ascontiguousarray(blocks), device=device)
    if dtype is not None:
        blocks_t = blocks_t.to(dtype)
    as_i32 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int32),
                                       device=device)
    return BlockCSR(shape=shape, block_size=B, row_ids=as_i32(rows),
                    col_ids=as_i32(cols), first=as_i32(first),
                    blocks=blocks_t, nnzb=nnzb)


def pack_blockcsr(
    x,
    block_size: int,
    *,
    capacity: int | None = None,
    dtype=None,
    eps: float = 0.0,
    device=None,
) -> BlockCSR:
    """Pack a dense matrix into ``BlockCSR``, skipping all-zero blocks.

    The scan runs on the host (a CUDA ``x`` is copied down once); the result
    lives on ``device`` (default: ``x``'s device, the CPU for numpy input).
    ``capacity`` pads the stored-block count with zero blocks on the LAST
    block-row (``first = 0``); ``eps`` is the nonzero tolerance.
    """
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    x = host(x)
    if x.ndim != 2:
        raise ValueError(f"BlockCSR expects a matrix, got shape {x.shape}")
    M, K = x.shape
    B = block_size
    nrb, ncb = _ceil_div(M, B), _ceil_div(K, B)
    padded = np.zeros((nrb * B, ncb * B), dtype=x.dtype)
    padded[:M, :K] = x

    xb = padded.reshape(nrb, B, ncb, B).transpose(0, 2, 1, 3)
    mask = block_nonzero_mask(xb, eps, axis=(2, 3))
    fill_rows = np.nonzero(~mask.any(axis=1))[0]
    r_real, c_real = np.nonzero(mask)          # row-major == (rb, cb) sorted
    rows_a = np.concatenate([r_real, fill_rows])
    cols_a = np.concatenate([c_real, np.zeros(len(fill_rows), np.int64)])
    blocks_a = np.concatenate(
        [xb[r_real, c_real], np.zeros((len(fill_rows), B, B), x.dtype)])
    order = np.lexsort((cols_a, rows_a))       # merge fillers into row order
    rows_a, cols_a, blocks_a = rows_a[order], cols_a[order], blocks_a[order]
    first_a = np.ones(len(rows_a), dtype=np.int32)
    first_a[1:] = (rows_a[1:] != rows_a[:-1]).astype(np.int32)

    nnzb = len(rows_a)
    cap = capacity if capacity is not None else nnzb
    if cap < nnzb:
        raise ValueError(f"capacity {cap} < stored blocks {nnzb}")
    pad = cap - nnzb
    if pad:
        rows_a = np.concatenate([rows_a, np.full(pad, nrb - 1, np.int64)])
        cols_a = np.concatenate([cols_a, np.zeros(pad, np.int64)])
        first_a = np.concatenate([first_a, np.zeros(pad, np.int32)])
        blocks_a = np.concatenate([blocks_a, np.zeros((pad, B, B), x.dtype)])
    return _make((M, K), B, rows_a, cols_a, first_a, blocks_a, nnzb, dtype,
                 device)


def pack_blockcsr_coo(
    shape: Tuple[int, int],
    rows,
    cols,
    vals,
    block_size: int,
    *,
    capacity: int | None = None,
    dtype=None,
    eps: float = 0.0,
    device="cpu",
) -> BlockCSR:
    """Pack COO triplets into ``BlockCSR`` WITHOUT a dense intermediate.

    Bit-identical to ``pack_blockcsr(dense_of(triplets), ...)``: duplicate
    coordinates are summed in triplet order (``np.add.at``), blocks whose
    summed magnitudes are all ``<= eps`` are skipped, empty block-rows keep
    a zero block at column 0, and ``capacity`` padding appends zero blocks on
    the last block-row.  The working set is O(nnz + stored_blocks · B²).
    """
    rows, cols, vals = host(rows), host(cols), host(vals)
    M, K = shape
    B = block_size
    nrb, ncb = _ceil_div(M, B), _ceil_div(K, B)
    if (np.any(rows >= M) or np.any(cols >= K)
            or np.any(rows < 0) or np.any(cols < 0)):
        raise ValueError(f"COO coordinate out of bounds for shape {(M, K)}")

    # candidate blocks = unique (block-row, block-col) pairs holding any nnz
    # (int64: block-grid sizes beyond 2^31 overflow the triplets' int32)
    key = rows.astype(np.int64) // B * ncb + cols // B
    uniq = np.unique(key)                       # sorted == (rb, cb) order
    blk_of = np.searchsorted(uniq, key)
    cand = np.zeros((len(uniq), B, B), dtype=vals.dtype)
    np.add.at(cand, (blk_of, rows % B, cols % B), vals)

    keep = block_nonzero_mask(cand, eps, axis=(1, 2))
    kept_keys = uniq[keep]
    kept_blocks = cand[keep]
    kept_rows = kept_keys // ncb
    kept_cols = kept_keys % ncb

    out_rows, out_cols, first, blocks = [], [], [], []
    ptr = 0
    zero_blk = np.zeros((B, B), dtype=vals.dtype)
    for rb in range(nrb):
        row_has_block = False
        while ptr < len(kept_keys) and kept_rows[ptr] == rb:
            out_rows.append(rb)
            out_cols.append(int(kept_cols[ptr]))
            first.append(0 if row_has_block else 1)
            blocks.append(kept_blocks[ptr])
            row_has_block = True
            ptr += 1
        if not row_has_block:  # keep output init coverage
            out_rows.append(rb)
            out_cols.append(0)
            first.append(1)
            blocks.append(zero_blk)

    nnzb = len(blocks)
    cap = capacity if capacity is not None else nnzb
    if cap < nnzb:
        raise ValueError(f"capacity {cap} < stored blocks {nnzb}")
    for _ in range(cap - nnzb):
        out_rows.append(nrb - 1)
        out_cols.append(0)
        first.append(0)
        blocks.append(zero_blk)
    return _make((M, K), B, out_rows, out_cols, first, np.stack(blocks), nnzb,
                 dtype, device)


def pair_block_triples(
    a: BlockCSR,
    y: BlockCSR,
    *,
    a_sentinel: int,
    y_sentinel: int,
    a_offset: int = 0,
    y_offset: int = 0,
    base_row: int = 0,
    base_col: int = 0,
    n_row_blocks: int | None = None,
    n_col_blocks: int | None = None,
) -> list[tuple[int, int, int, int]]:
    """Block-level Pairing Unit (Alg. 3 lines 3-5), region-relocatable.

    Each output block ``Z[jb, kb]`` receives one ``(a_id, y_id)`` pair per
    stored pair ``(A[jb, ib], Y[ib, kb])``, plus one ``(a_sentinel,
    y_sentinel)`` pair for every output block of the ``n_row_blocks x
    n_col_blocks`` region that receives no contribution (so the kernel
    initializes it).  Returns UNSORTED ``(out_row, out_col, a_id, y_id)``
    quadruples in stored-block order.
    """
    a_rows = host(a.row_ids)[: a.stored_blocks]
    a_cols = host(a.col_ids)[: a.stored_blocks]
    y_rows = host(y.row_ids)[: y.stored_blocks]
    y_cols = host(y.col_ids)[: y.stored_blocks]
    n_row_blocks = a.n_block_rows if n_row_blocks is None else n_row_blocks
    n_col_blocks = y.n_block_cols if n_col_blocks is None else n_col_blocks

    y_by_row: dict[int, list[tuple[int, int]]] = {}
    for yid, (ib, kb) in enumerate(zip(y_rows, y_cols)):
        y_by_row.setdefault(int(ib), []).append((yid, int(kb)))

    triples: list[tuple[int, int, int, int]] = []
    covered: set[tuple[int, int]] = set()
    for aid, (jb, ib) in enumerate(zip(a_rows, a_cols)):
        for yid, kb in y_by_row.get(int(ib), ()):
            triples.append((base_row + int(jb), base_col + kb,
                            a_offset + aid, y_offset + yid))
            covered.add((int(jb), kb))
    for jb in range(n_row_blocks):
        for kb in range(n_col_blocks):
            if (jb, kb) not in covered:
                triples.append((base_row + jb, base_col + kb,
                                a_sentinel, y_sentinel))
    return triples


def first_visit_flags(out_rows: np.ndarray, out_cols: np.ndarray) -> np.ndarray:
    """1 on the first entry of each (out_row, out_col) run (zero-init)."""
    first = np.zeros(len(out_rows), dtype=np.int32)
    seen: set[tuple[int, int]] = set()
    for i, (r, c) in enumerate(zip(out_rows, out_cols)):
        if (r, c) not in seen:
            first[i] = 1
            seen.add((r, c))
    return first


def spmm_triples(a: BlockCSR, y: BlockCSR):
    """Host-side pairing for a single-task SpMM: ``(a_ids, y_ids, out_rows,
    out_cols, first)`` sorted by output block, with one sentinel pair (ids
    ``stored_blocks``) for every output block that receives nothing."""
    if a.shape[1] != y.shape[0]:
        raise ValueError(f"spmm shape mismatch: {a.shape} x {y.shape}")
    if a.block_size != y.block_size:
        raise ValueError("spmm requires equal block sizes")

    triples = pair_block_triples(a, y, a_sentinel=a.stored_blocks,
                                 y_sentinel=y.stored_blocks)
    triples.sort()

    out_rows = np.array([t[0] for t in triples], dtype=np.int32)
    out_cols = np.array([t[1] for t in triples], dtype=np.int32)
    a_ids = np.array([t[2] for t in triples], dtype=np.int32)
    y_ids = np.array([t[3] for t in triples], dtype=np.int32)
    return a_ids, y_ids, out_rows, out_cols, first_visit_flags(out_rows, out_cols)


def _key_changes(out_rows: torch.Tensor, out_cols: torch.Tensor):
    """True at every entry whose ``(out_row, out_col)`` key differs from the
    previous entry's (and at entry 0)."""
    n = int(out_rows.shape[0])
    change = torch.ones(n, dtype=torch.bool, device=out_rows.device)
    if n > 1:
        change[1:] = ((out_rows[1:] != out_rows[:-1])
                      | (out_cols[1:] != out_cols[:-1]))
    return change


def run_starts(out_rows: torch.Tensor, out_cols: torch.Tensor) -> torch.Tensor:
    """Start offsets of the output-block runs of a sorted descriptor list,
    plus the total length as a closing sentinel: ``(n_runs + 1,)`` int32 on
    the descriptors' device.  A run is a maximal stretch of consecutive
    entries with one ``(out_row, out_col)`` key — found from key changes,
    never from the ``first`` flags (a ``first`` may reset mid-run).  One
    host sync for the run count."""
    starts = torch.nonzero(_key_changes(out_rows, out_cols)).flatten()
    end = torch.full((1,), int(out_rows.shape[0]), dtype=starts.dtype,
                     device=starts.device)
    return torch.cat([starts, end]).to(torch.int32)
