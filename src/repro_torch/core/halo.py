"""Static halo-exchange schedules for owned-operand sharding.

The replicated sharded executor ships the whole stripe-padded dense operand
``Y`` to every shard — O(N·width) memory per shard.  This module implements
the "own your band, exchange your halo" layout instead:

- **Ownership** partitions the ``ncb = ceil(K / B)`` block-rows of the
  stripe-padded operand contiguously across shards
  (:func:`ownership_starts`).  When the kernel is square on the adjacency
  (``M == K``) and row tiles are block-aligned, ownership follows the band
  placement itself, so a block-diagonal graph reads only blocks it already
  owns and exchanges NOTHING.
- **Column support** (:class:`ColumnSupport`) is what one shard's band
  actually reads: its owned block-row range plus the sorted ``halo`` of
  foreign block-rows named by its SpDMM/SpMM descriptors.  A band with real
  GEMM tasks reads every block-row (``full=True``).
- **Schedule** (:func:`build_exchange`) compiles the supports into static
  per-shard index arrays for a ring of ``nd - 1`` rounds: in round ``r``
  shard ``d`` holds the owned slab of shard ``(d-1-r) % nd`` and copies the
  blocks it needs into its local owned+halo buffer.  Take lists are padded
  to ``max_take`` with writes into a DUMP slot (local slot ``L``) that no
  descriptor reads for an output row.
- **Execution** (:func:`exchange`) is a single-controller ring: each round
  passes every shard's transiting slab to the next shard's device, then
  each shard scatters the blocks it takes into its ``(L + 1, B, W)`` local
  buffer, whose slots the lowered descriptors index directly.

The exchange only moves data: descriptor entry ORDER is untouched (only the
block-row indices are remapped to local slots), so every output block sees
the same float contributions in the same order as in the replicated layout,
and the results are bitwise equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ColumnSupport:
    """Column support of ONE shard's band over the dense operand.

    ``[own_start, own_stop)`` is the owned block-row range; ``halo`` the
    sorted foreign block-rows the band's descriptors read.  ``full=True``
    marks a band with real GEMM tasks — it reads every block-row, so its
    memory is accounted as replicated-fallback rather than owned+halo.
    """
    own_start: int
    own_stop: int
    halo: tuple[int, ...]
    full: bool = False

    @property
    def n_owned(self) -> int:
        return self.own_stop - self.own_start

    def local_blocks(self) -> list[int]:
        """Global block-rows resident in this shard's local buffer, in
        local-slot order (sorted; owned and halo ranges are disjoint)."""
        return sorted(set(range(self.own_start, self.own_stop))
                      | set(self.halo))


@dataclasses.dataclass(frozen=True)
class HaloGeometry:
    """Static half of an exchange schedule.

    ``L`` is the local-buffer slot count excluding the dump slot (the
    buffer is ``(L + 1, B, W)`` with slot ``L`` absorbing padded writes);
    ``max_own``/``max_take`` equalize slab and take shapes across shards.
    ``n_rounds`` is ``nd - 1`` when anything is exchanged, else 0 — an
    empty-halo plan (block-diagonal graph) runs zero rounds.
    """
    n_devices: int
    ncb: int
    own_starts: tuple[int, ...]
    L: int
    max_own: int
    n_rounds: int
    max_take: int


def ownership_starts(M: int, K: int, tile_m: int, band_starts, block: int
                     ) -> tuple[int, ...]:
    """Contiguous ownership split of the ``ncb`` operand block-rows.

    Band-aligned when the kernel is square on the adjacency (``M == K``)
    and row tiles are block-aligned — then shard ``d`` owns exactly the
    operand rows its own band produces, and block-diagonal structure makes
    every halo empty.  Otherwise an even contiguous split.
    """
    ncb = -(-K // block)
    nd = len(band_starts) - 1
    if M == K and tile_m % block == 0:
        bpt = tile_m // block
        starts = [min(int(bs) * bpt, ncb) for bs in band_starts]
        starts[-1] = ncb
    else:
        starts = [d * ncb // nd for d in range(nd)] + [ncb]
    return tuple(starts)


def build_exchange(supports, own_starts, *, gather: bool):
    """Compile column supports into a static ring-exchange schedule.

    Returns ``(HaloGeometry, own_dst, src, dst, gather_idx)`` numpy index
    arrays (leading shard axis):

    - ``own_dst (nd, max_own)``: local slot of each owned block (pads → L);
    - ``src/dst (nd, n_rounds, max_take)``: per round, which slab slots to
      take from the transiting owned buffer and where to scatter them;
    - ``gather_idx (nd, ncb)`` (``gather=True`` only): local slot of every
      global block-row, for full-operand reconstruction on GEMM bands
      (blocks a shard never received stay at the dump slot — such shards
      only run PAD gemm tasks against all-zero X slabs).
    """
    nd = len(supports)
    ncb = int(own_starts[-1])
    locs = []
    for cs in supports:
        locs.append({g: i for i, g in enumerate(cs.local_blocks())})
    L = max((len(m) for m in locs), default=0)
    max_own = max(own_starts[d + 1] - own_starts[d] for d in range(nd))
    owner = np.searchsorted(own_starts, np.arange(ncb), side="right") - 1

    takes = [[[] for _ in range(max(nd - 1, 0))] for _ in range(nd)]
    for d, cs in enumerate(supports):
        for g in cs.halo:
            o = int(owner[g])
            r = (d - o - 1) % nd
            takes[d][r].append((g - int(own_starts[o]), locs[d][g]))
    max_take = max((len(t) for row in takes for t in row), default=0)
    n_rounds = nd - 1 if max_take else 0

    own_dst = np.full((nd, max_own), L, np.int32)
    for d in range(nd):
        for s in range(own_starts[d + 1] - own_starts[d]):
            own_dst[d, s] = locs[d][int(own_starts[d]) + s]

    src = np.zeros((nd, n_rounds, max_take), np.int32)
    dst = np.full((nd, n_rounds, max_take), L, np.int32)
    for d in range(nd):
        for r in range(n_rounds):
            for k, (s, t) in enumerate(takes[d][r]):
                src[d, r, k] = s
                dst[d, r, k] = t

    gather_idx = None
    if gather:
        gather_idx = np.full((nd, ncb), L, np.int32)
        for d in range(nd):
            for g, p in locs[d].items():
                gather_idx[d, g] = p

    hg = HaloGeometry(n_devices=nd, ncb=ncb, own_starts=tuple(own_starts),
                      L=L, max_own=max_own, n_rounds=n_rounds,
                      max_take=max_take)
    return hg, own_dst, src, dst, gather_idx


def exchange(shards, y_own, hg: HaloGeometry, devices):
    """Single-controller ring exchange over the mesh ``devices``.

    ``shards[d]`` holds shard ``d``'s schedule arrays (``hx_own_dst``,
    ``hx_src``, ``hx_dst``) and ``y_own[d]`` its ``(max_own, B, W)`` owned
    slab, both on ``devices[d]``.  Each shard's zeroed ``(L + 1, B, W)``
    buffer receives its owned slab; then, in each of ``n_rounds`` rounds,
    every slab in transit moves one shard on (shard ``d`` receives shard
    ``d - 1``'s, the reference's ``ppermute`` with ``perm = [(i, i + 1)]``)
    and each shard copies the blocks it takes into its buffer.  Returns the
    buffers.  Pad writes all land in the dump slot ``L``; which of them
    wins is unspecified, and no real output reads that slot.  Only device
    operations: the exchange runs inside a captured CUDA graph too.
    """
    nd = hg.n_devices
    _, B, W = y_own[0].shape
    bufs = []
    for d in range(nd):
        buf = torch.zeros((hg.L + 1, B, W), dtype=y_own[d].dtype,
                          device=devices[d])
        buf[shards[d]["hx_own_dst"].long()] = y_own[d]
        bufs.append(buf)
    transit = list(y_own)
    for r in range(hg.n_rounds):
        transit = [transit[(d - 1) % nd].to(devices[d]) for d in range(nd)]
        for d in range(nd):
            take = shards[d]["hx_src"][r].long()
            bufs[d][shards[d]["hx_dst"][r].long()] = transit[d][take]
    return bufs


def operand_bytes(supports, hg: HaloGeometry, block: int, width: int,
                  *, mode: str = "halo", bytes_per_elem: int = 4) -> dict:
    """Analytic per-shard dense-operand memory of a sharded dispatch.

    ``width`` is the stripe-padded operand width (``nct * SN``).  The
    resident per-shard footprint is uniform across shards: the owned input
    slab plus the owned+halo buffer with its dump slot.  The replicated
    baseline is the full ``ncb`` block-rows on every shard.
    """
    bb = block * width * bytes_per_elem
    per_device = []
    owned_b = halo_b = fallback_b = 0
    for cs in supports:
        o, h = cs.n_owned * bb, len(cs.halo) * bb
        if cs.full:
            per_device.append({"owned_bytes": o, "halo_bytes": 0,
                               "fallback_bytes": h, "full": True})
            fallback_b += h
        else:
            per_device.append({"owned_bytes": o, "halo_bytes": h,
                               "fallback_bytes": 0, "full": False})
            halo_b += h
        owned_b += o
    return {
        "mode": mode,
        "per_device": per_device,
        "owned_bytes": owned_b,
        "halo_bytes": halo_b,
        "fallback_bytes": fallback_b,
        "halo_per_device_bytes": (hg.max_own + hg.L + 1) * bb,
        "replicated_per_device_bytes": hg.ncb * bb,
    }
