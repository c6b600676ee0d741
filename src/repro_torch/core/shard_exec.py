"""Sharded compiled dispatch — one banded program per mesh shard.

A device-placed plan (``KernelPlan.placement`` from
:func:`repro_torch.core.analyzer.analyze_sharded`) lowers here into a
:class:`ShardedDispatch`: the same descriptor arrays a
:class:`~repro_torch.core.dispatch.CompiledDispatch` carries, but banded by
shard (leading shard axis, contiguous LOCAL row numbering inside each band).
One controller runs every shard: shard ``d`` runs the shared
:func:`~repro_torch.core.dispatch.apply_prepared` body on ``mesh.devices[d]``
and the bands' rows are concatenated on ``mesh.devices[0]``.  Mesh size 1
is the degenerate case of the same code path, bitwise equal to the
unsharded executor (see below).

Uniform shard geometry via a GHOST row-tile
-------------------------------------------
Every shard has the same geometry (the reference's ``shard_map`` asks for
it, and the stacked arrays keep it): ``nrt_local = max_band_tiles + 1`` row
tiles, real bands in a prefix, and an extra GHOST tile that absorbs the
descriptor padding which equalizes per-shard entry counts:

- GEMM pads address output tile ``(nrt_local - 1, 0)``; the X slab of the
  ghost tile is all zeros, so the scatter writes zeros there;
- SpDMM / SpMM pads reference an appended all-zero pool block with
  ``first = 0`` at the ghost tile's first block-row, so they ACCUMULATE
  ``0 · Y`` into a zeroed canvas block (an exact bitwise no-op).

Owned-operand sharding with halo exchange (``operand_sharding="halo"``)
-----------------------------------------------------------------------
By default the dense operand Y is not replicated.  Lowering runs a
per-band COLUMN-SUPPORT analysis over the descriptors it just built (SpDMM
entries name their Y block-rows directly; SpMM triples encode them in
``y_ids``; GEMM bands read everything → replicated fallback), emits one
:class:`repro_torch.core.halo.ColumnSupport` per shard, and compiles a
static ring-exchange schedule (:func:`repro_torch.core.halo.build_exchange`).
Y is split by block-row OWNERSHIP, the ring
(:func:`repro_torch.core.halo.exchange`) copies halo blocks into each
shard's local ``(L + 1)`` slot buffer, and the SpDMM/SpMM descriptors —
rewritten at lowering time from global block-rows to local buffer slots —
feed the same fused kernels.  ``operand_sharding="replicate"`` ships Y
whole to every shard: the bitwise correctness oracle.

Bitwise identity with the unsharded executor holds because every REAL
output block receives exactly the contribution sequence it receives
globally: the per-band entry sort (local ``out_row`` = global ``out_row`` −
band offset) keeps the global per-block order, the exchange only moves
rows that ``_stripe_padded_y`` lays out globally, and the float
accumulation order per block is unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dispatch as _dispatch
from repro_torch.core import halo as _halo
from repro_torch.device import host

OPERAND_SHARDINGS = ("halo", "replicate")


@dataclasses.dataclass
class ShardedDispatch:
    """Shard-banded instruction stream of one placed kernel.

    ``geom`` is the per-shard LOCAL geometry (uniform across shards:
    ``nrt = max_band_tiles + 1`` with the ghost tile, ``M = m_pad``).
    ``arrays`` mirrors :class:`~repro_torch.core.dispatch.CompiledDispatch`
    ``.arrays`` with a leading shard axis — in halo mode including the
    exchange schedule (``hx_*``) — as one tensor per name on the lowering
    mesh's first device.  :meth:`shards` hands out shard ``d``'s slice of
    every array on ``devices[d]`` (uploaded once per device tuple; a view
    where the device is the stacked arrays' own).  ``band_rows[d]`` is the
    count of logical output rows shard ``d`` owns.  ``halo`` is the static
    :class:`~repro_torch.core.halo.HaloGeometry` (``None`` → replicated
    operand), ``supports`` the per-shard column supports, and
    ``operand_bytes`` the analytic per-shard dense-operand memory
    (``dispatch_stats()`` aggregates it).
    """
    geom: _dispatch.DispatchGeometry
    n_devices: int
    band_starts: tuple[int, ...]
    band_rows: tuple[int, ...]
    M: int                             # global logical row count
    arrays: dict[str, torch.Tensor]
    fingerprint: str
    supports: tuple = ()
    halo: object = None                # _halo.HaloGeometry | None
    operand_sharding: str = "replicate"
    operand_bytes: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        # device tuple -> per-shard slices (not a field: snapshots and the
        # byte account see only the stacked arrays)
        self._shards: dict = {}

    @property
    def needs_x(self) -> bool:
        return self.geom.has_gemm

    def shards(self, devices) -> tuple[dict[str, torch.Tensor], ...]:
        """Shard ``d``'s slice of every array, on ``devices[d]``."""
        key = tuple(str(d) for d in devices)
        out = self._shards.get(key)
        if out is None:
            if len(key) != self.n_devices:
                raise ValueError(f"a {self.n_devices}-shard dispatch on a "
                                 f"mesh of {len(key)} devices")
            out = tuple({k: v[d].to(dev) for k, v in self.arrays.items()}
                        for d, dev in enumerate(devices))
            self._shards[key] = out
        return out


def _pool_dtype(stripes):
    for s in stripes.values():
        return host(s.blocks[:0]).dtype
    return np.dtype(np.float32)


def _band_tasks(tasks, placement, d):
    lo, hi = placement.band_starts[d], placement.band_starts[d + 1]
    return [dataclasses.replace(t, i=t.i - lo) for t in tasks if lo <= t.i < hi]


def _column_supports(per_gemm, per_spdmm, per_spmm, own_starts, ncb, nyc):
    """Per-shard :class:`~repro_torch.core.halo.ColumnSupport` from the
    lowered descriptor arrays: SpDMM entries carry Y block-rows in
    ``y_rows``, SpMM triples carry ``block_row * nyc + block_col`` in
    ``y_ids``, and a band with real GEMM tasks reads the whole operand
    (replicated fallback)."""
    nd = len(own_starts) - 1
    supports = []
    for d in range(nd):
        full = len(per_gemm[d]) > 0
        if full:
            read = set(range(ncb))
        else:
            read = set()
            e = per_spdmm[d][1]
            if e is not None:
                read.update(int(g) for g in np.unique(e[1]))
            e = per_spmm[d][1]
            if e is not None:
                read.update(int(g) for g in np.unique(e[1] // nyc))
        own = range(own_starts[d], own_starts[d + 1])
        supports.append(_halo.ColumnSupport(
            own_start=own_starts[d], own_stop=own_starts[d + 1],
            halo=tuple(sorted(read - set(own))), full=full))
    return tuple(supports)


def _localize_entries(supports, per_spdmm, per_spmm, ncb, nyc):
    """Rewrite Y indices from GLOBAL block-rows to LOCAL owned+halo buffer
    slots, per shard.  Entry order (hence accumulation order) untouched."""
    sp_out, mm_out = [], []
    for cs, (sp_pool, sp_e), (mm_pool, mm_e) in zip(
            supports, per_spdmm, per_spmm):
        lut = np.zeros(ncb, np.int64)
        for slot, g in enumerate(cs.local_blocks()):
            lut[g] = slot
        if sp_e is not None:
            sp_e = (sp_e[0], lut[sp_e[1]], sp_e[2], sp_e[3], sp_e[4])
        if mm_e is not None:
            mm_e = (mm_e[0], lut[mm_e[1] // nyc] * nyc + mm_e[1] % nyc,
                    mm_e[2], mm_e[3], mm_e[4])
        sp_out.append((sp_pool, sp_e))
        mm_out.append((mm_pool, mm_e))
    return sp_out, mm_out


def _stack_section(per_dev, n_entries, names, pad_cols):
    """Pad each shard's (pool, entry-arrays) to common shapes and stack.
    ``pad_cols[k]`` gives the pad value of entry column ``k`` as a function
    of the padded pool length."""
    pool_len = max(len(p) for p, _ in per_dev) + 1   # +1 zero sentinel
    pools, columns = [], [[] for _ in names]
    for pool, entries in per_dev:
        pools.append(np.concatenate(
            [pool, np.zeros((pool_len - len(pool),) + pool.shape[1:],
                            pool.dtype)], axis=0))
        cols = (entries if entries is not None
                else tuple(np.zeros(0, np.int32) for _ in names))
        pad_n = n_entries - len(cols[0])
        for k, c in enumerate(cols):
            columns[k].append(np.concatenate(
                [c, np.full(pad_n, pad_cols[k](pool_len), dtype=np.int32)]))
    out = {"pool": np.stack(pools)}
    for k, name in enumerate(names):
        out[name] = np.stack(columns[k]).astype(np.int32)
    return out


def build_sharded_dispatch(part, stq, dtq, stripes, placement,
                           *, block: int, eps: float = 0.0,
                           fingerprint: str = "",
                           operand_sharding: str = "halo",
                           faults: object = None,
                           devices) -> ShardedDispatch | None:
    """Lower a device-placed plan into a :class:`ShardedDispatch`.

    Same O(nnz blocks) vectorized-numpy cost as
    :func:`~repro_torch.core.dispatch.build_dispatch`, paid once per
    (structure, assignment, mesh geometry, operand-sharding mode); ``None``
    when the canvas geometry cannot take the in-place layout (the caller
    falls back to the eager path, which is placement-agnostic).  The
    stacked arrays go to ``devices[0]`` (the mesh's first device) and each
    shard's slice to its own device, once, here.  ``faults`` is the
    optional fault injector probed at the ``shard_lower`` site.
    """
    if operand_sharding not in OPERAND_SHARDINGS:
        raise ValueError(f"operand_sharding must be one of "
                         f"{OPERAND_SHARDINGS}, got {operand_sharding!r}")
    if faults is not None:
        faults.probe("shard_lower", detail=f"shard:{part.name}")
    slots = _dispatch.canvas_slots(part, block)
    if slots is None:
        return None
    SM, SN = slots
    B = block
    R, C = SM // B, SN // B
    nd = placement.n_devices
    bs = placement.band_starts
    max_band = max(placement.band_sizes()) if nd else 0
    nrt_l = max_band + 1                       # +1 ghost tile for padding
    ghost_row = (nrt_l - 1) * R                # first block-row of the ghost

    band_rows = tuple(
        sum(part.row_extent(i) for i in placement.stripes_of(d))
        for d in range(nd))

    per_gemm, per_spdmm, per_spmm = [], [], []
    for d in range(nd):
        lo = bs[d]
        local_stripes = {i - lo: stripes[i] for i in placement.stripes_of(d)
                         if i in stripes}
        g = _band_tasks(dtq, placement, d)
        sp = _band_tasks([t for t in stq if t.primitive != "SpMM"],
                         placement, d)
        mm = _band_tasks([t for t in stq if t.primitive == "SpMM"],
                         placement, d)
        per_gemm.append(g)

        if sp:
            offsets, pool = _dispatch._stripe_pool(sp, local_stripes)
            per_spdmm.append((host(pool),
                              _dispatch.spdmm_entry_arrays(
                                  sp, local_stripes, offsets, R)))
        else:
            per_spdmm.append((np.zeros((0, B, B), _pool_dtype(stripes)),
                              None))

        if mm:
            offsets, pool = _dispatch._stripe_pool(mm, local_stripes)
            per_spmm.append((host(pool),
                             _dispatch._spmm_dense_y_triples(
                                 mm, part, local_stripes, offsets, R, C,
                                 n_y_block_cols=part.n_col_tiles * C)))
        else:
            per_spmm.append((np.zeros((0, B, B), _pool_dtype(stripes)),
                             None))

    n_gemm = max((len(g) for g in per_gemm), default=0)

    ncb = -(-part.K // B)
    nyc = part.n_col_tiles * C                 # Y pool blocks per block-row
    supports: tuple = ()
    hg = None
    arrays: dict[str, np.ndarray] = {}
    if operand_sharding == "halo":
        own_starts = _halo.ownership_starts(part.M, part.K, part.tile_m,
                                            bs, B)
        supports = _column_supports(per_gemm, per_spdmm, per_spmm,
                                    own_starts, ncb, nyc)
        per_spdmm, per_spmm = _localize_entries(supports, per_spdmm,
                                                per_spmm, ncb, nyc)
        hg, own_dst, hx_src, hx_dst, gather = _halo.build_exchange(
            supports, own_starts, gather=n_gemm > 0)
        arrays.update(hx_own_dst=own_dst, hx_src=hx_src, hx_dst=hx_dst)
        if gather is not None:
            arrays["hx_gather"] = gather

    n_sp = max((0 if e is None else len(e[0]) for _, e in per_spdmm),
               default=0)
    n_mm = max((0 if e is None else len(e[0]) for _, e in per_spmm),
               default=0)

    geom = _dispatch.DispatchGeometry(
        M=nrt_l * SM, K=part.K, N=part.N, tm=part.tile_m, tn=part.tile_n,
        SM=SM, SN=SN, B=B, nrt=nrt_l, nct=part.n_col_tiles,
        has_gemm=n_gemm > 0, has_spdmm=n_sp > 0, has_spmm=n_mm > 0,
        eps=eps)

    if n_gemm:
        rows = np.full((nd, n_gemm), nrt_l - 1, dtype=np.int32)
        cols = np.zeros((nd, n_gemm), dtype=np.int32)
        for d, g in enumerate(per_gemm):
            rows[d, :len(g)] = [t.i for t in g]
            cols[d, :len(g)] = [t.j for t in g]
        arrays["gemm_rows"] = rows
        arrays["gemm_cols"] = cols

    # pads: zero-sentinel A block × Y row 0 → ghost block, first=0 (in halo
    # mode Y row 0 is local slot 0 — any resident block works: a zero A
    # block accumulates an exact bitwise no-op)
    pads = (lambda pl: pl - 1, lambda pl: 0, lambda pl: ghost_row,
            lambda pl: 0, lambda pl: 0)
    for prefix, per_dev, n, names in (
            ("sp", per_spdmm, n_sp,
             ("a_ids", "y_rows", "out_rows", "out_cols", "first")),
            ("mm", per_spmm, n_mm,
             ("a_ids", "y_ids", "out_rows", "out_cols", "first"))):
        if n:
            sec = _stack_section(per_dev, n, names, pads)
            arrays[f"{prefix}_pool"] = sec["pool"]
            for name in names:
                arrays[f"{prefix}_{name}"] = sec[name]

    width = part.n_col_tiles * SN
    if operand_sharding == "halo":
        op_bytes = _halo.operand_bytes(supports, hg, B, width)
    else:
        bb = B * width * 4
        op_bytes = {"mode": "replicate", "per_device": [
            {"owned_bytes": 0, "halo_bytes": 0, "fallback_bytes": ncb * bb,
             "full": True} for _ in range(nd)],
            "owned_bytes": 0, "halo_bytes": 0,
            "fallback_bytes": nd * ncb * bb,
            "halo_per_device_bytes": ncb * bb,
            "replicated_per_device_bytes": ncb * bb}

    sd = ShardedDispatch(
        geom=geom, n_devices=nd, band_starts=tuple(bs), band_rows=band_rows,
        M=part.M, arrays={k: torch.as_tensor(v, device=devices[0])
                          for k, v in arrays.items()},
        fingerprint=fingerprint, supports=supports, halo=hg,
        operand_sharding=operand_sharding, operand_bytes=op_bytes)
    sd.shards(devices)
    return sd


def _on(dev):
    """The device context a shard's launches need: kernels go to the
    current stream of the current card."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _x_slabs(geom, band_rows, x, devices):
    """Per-band X slabs padded to the uniform shard height, each on its
    shard's device."""
    slabs, row0 = [], 0
    for r, dev in zip(band_rows, devices):
        sl = x[row0:row0 + r]
        slabs.append(F.pad(sl, (0, 0, 0, geom.m_pad - r)).to(dev))
        row0 += r
    return slabs


def _y_owned_slabs(geom, halo, y, devices):
    """Owned block-row slabs of the stripe-padded operand, padded to
    ``max_own`` rows of blocks, each on its owner's device."""
    B = geom.B
    W = geom.nct * geom.SN
    yb = _dispatch._stripe_padded_y(geom, y).reshape(geom.ncb, B, W)
    slabs = []
    for d, dev in enumerate(devices):
        sl = yb[halo.own_starts[d]:halo.own_starts[d + 1]]
        slabs.append(F.pad(sl, (0, 0, 0, 0, 0, halo.max_own - sl.shape[0]))
                     .to(dev))
    return slabs


def apply_sharded(geom, band_rows, shards, x, y, *, devices, halo=None):
    """Sharded executor body: slab X per band (and, in halo mode, slab Y
    per OWNER and run the ring exchange), run the shared
    :func:`~repro_torch.core.dispatch.apply_prepared` body of shard ``d``
    on ``devices[d]``, then concatenate each band's logical rows on
    ``devices[0]``.  ``shards`` is :meth:`ShardedDispatch.shards` of
    ``devices``; ``x`` and ``y`` live on ``devices[0]``.  Only device
    operations, so a compiled model captures it in its CUDA graph."""
    if geom.has_gemm and x is None:
        raise ValueError("sharded dispatch: dense-queue tasks need the "
                         "densified x operand (got x=None)")
    nd = len(band_rows)
    x_sl = (_x_slabs(geom, band_rows, x, devices) if geom.has_gemm
            else [None] * nd)
    has_sp = geom.has_spdmm or geom.has_spmm
    zs = []
    if halo is None:
        # replicated-operand oracle: Y laid out once, shipped whole
        y_f = _dispatch._stripe_padded_y(geom, y) if has_sp else None
        y_p = _dispatch._gemm_y_panel(geom, y) if geom.has_gemm else None
        for d, dev in enumerate(devices):
            with _on(dev):
                zs.append(_dispatch.apply_prepared(
                    geom, shards[d], x_sl[d],
                    None if y_f is None else y_f.to(dev),
                    None if y_p is None else y_p.to(dev)))
    else:
        B, W = geom.B, geom.nct * geom.SN
        y_own = _y_owned_slabs(geom, halo, y, devices)
        bufs = _halo.exchange(shards, y_own, halo, devices)
        for d, dev in enumerate(devices):
            y_pl = None
            if geom.has_gemm:
                y_pl = bufs[d][shards[d]["hx_gather"].long()].reshape(
                    geom.ncb * B, geom.nct, geom.SN)[:geom.K]
            with _on(dev):
                zs.append(_dispatch.apply_prepared(
                    geom, shards[d], x_sl[d],
                    bufs[d].reshape((halo.L + 1) * B, W), y_pl))
    home = devices[0]
    parts = [zs[d][:band_rows[d]].to(home) for d in range(nd) if band_rows[d]]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _shard_signature(sd, x, y, mesh):
    arr_sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in sd.arrays.items()))
    x_sig = None if x is None else (tuple(x.shape), str(x.dtype))
    return ("shard", sd.geom, sd.band_rows, sd.halo, arr_sig, x_sig,
            tuple(y.shape), str(y.dtype), tuple(str(d) for d in mesh.devices))


def execute_sharded(sd: ShardedDispatch, x, y, *, mesh, stats=None,
                    faults=None) -> torch.Tensor:
    """Run one sharded compiled kernel on ``mesh`` with zero host
    descriptor work.  Shares the executor-signature ledger with the
    unsharded executor, so ``CacheStats`` trace accounting stays one
    ledger.  ``faults`` is probed at the ``shard_exec`` site."""
    if faults is not None:
        faults.probe("shard_exec",
                     detail=f"nd:{sd.n_devices}:{sd.operand_sharding}")
    key = _shard_signature(sd, x, y, mesh)
    with _dispatch._TRACE_LOCK:
        hit = key in _dispatch._TRACE_SEEN
        _dispatch._TRACE_SEEN.add(key)
    if stats is not None:
        if hit:
            stats.trace_cache_hits += 1
        else:
            stats.trace_builds += 1
    return apply_sharded(sd.geom, sd.band_rows, sd.shards(mesh.devices), x,
                         y, devices=mesh.devices, halo=sd.halo)
