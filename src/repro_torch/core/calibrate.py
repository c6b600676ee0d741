"""Measured performance model — microbenchmark-calibrated Table I closed forms.

The runtime mapping (Alg. 4) is only as good as its performance model.
``VCK5000`` is analytical by design (it reproduces the paper's tables), but
the runtime models (the ``fallback=True`` entries of
:mod:`repro_torch.core.perfmodel`) are data-sheet guesses.  This module
replaces the guesses with measurements of the kernels the port runs:

- :func:`calibrate` times the ACTUAL kernels the dispatcher issues —
  ``gemm_batch_scatter`` tiles (the dense queue), per-stored-block
  ``spdmm_fused`` / ``spmm_fused`` cost (the sparse queues), the device
  packer ``pack_activation_stripes`` as a compiled program runs it, and the
  per-launch dispatch floor — over the reference's small shape/density
  sweep, then least-squares fits ``t = c0 + c1 * effective_MACs`` per
  engine and re-derives the :class:`HardwareModel` parameters (per-MAC
  rates, ``dispatch_overhead``, effective memory bandwidth) into a
  :class:`CalibratedModel`.
- The fitted bandwidth is cross-checked against an analytic count of a
  reference 256 x 256 x 256 float32 product (``roofline_bw_ratio``, ~O(1)
  when the two agree about the same device).
- :func:`get_calibrated` keeps the fit in a
  :class:`~repro_torch.core.plancache.PlanCache` (and therefore in
  ``SharedPlanCache`` snapshots) keyed by (device kind, block, dtype, base
  model) with ``calib_builds`` / ``calib_hits`` accounting, plus an
  optional file snapshot (``REPRO_CALIBRATION_PATH``), so a restarted
  process replays ZERO measurements.

Timing is the reference's: min-of-repeats host wall time after one warmup
call, each call ended by a device synchronization.  The fit's intercept and
the dispatch floor stand for the launch cost the eager dispatcher pays, so
the marginal samples are timed as eager launches; only the packer, which
runs inside a compiled program, is timed as a CUDA-graph replay.  Every
sample and fit is logged (logger ``repro_torch.core.calibrate``, level
INFO), including whether a fit's slope was clamped.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from repro_torch import snapshot
from repro_torch.core.perfmodel import HardwareModel
from repro_torch.device import capture_graph, resolve_device
from repro_torch.kernels import ops

logger = logging.getLogger(__name__)

# number of microbenchmark kernel timings taken by THIS process — the
# observable for "a restart replays zero measurements"
_MEASUREMENTS = 0


def measurement_count() -> int:
    return _MEASUREMENTS


def reset_measurement_count() -> None:
    global _MEASUREMENTS
    _MEASUREMENTS = 0


@dataclasses.dataclass(frozen=True)
class CalibratedModel(HardwareModel):
    """A :class:`HardwareModel` whose rates were FIT from measured kernel
    timings.  The Table I closed forms are unchanged — only the parameters
    move — so the Analyzer/Scheduler consume it transparently.  Extra
    fields carry the fit's provenance and quality."""
    backend: str = ""          # device kind at measurement time
    block: int = 8             # block size the sweep used
    dtype: str = "float32"
    base: str = ""             # fallback model the frequencies came from
    n_samples: int = 0         # timed kernel invocations behind the fit
    gemm_s_per_mac: float = 0.0     # fitted marginal costs (seconds)
    spdmm_s_per_mac: float = 0.0    # ...per EFFECTIVE (stored-block) MAC
    spmm_s_per_mac: float = 0.0
    pack_s_per_slot: float = 0.0    # activation packer marginal slot cost
    fit_residual: float = 0.0       # max relative RMS across the fits
    roofline_flops: float = 0.0     # analytic count of the cross-check GEMM
    roofline_bytes: float = 0.0
    roofline_bw_ratio: float = 0.0  # implied achieved bw / fitted bw


def device_kind(device="cuda") -> str:
    """``"cuda:<card name>"`` for a CUDA device, else the device type
    (``"cpu"``): measurements taken on one kind are never replayed on
    another."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(dev)
    return dev.type


def calibration_key(base: HardwareModel, block: int, dtype: str, *,
                    device="cuda") -> tuple:
    """(device kind, block, dtype, base name) — the persistence key."""
    return (device_kind(device), int(block), str(dtype), base.name)


# ------------------------------------------------------------ measurement
def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn, *, repeats: int, device: torch.device) -> float:
    """Min-of-repeats wall time of ``fn()`` after one warmup call, each
    call ended by a device synchronization."""
    global _MEASUREMENTS
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    _MEASUREMENTS += 1
    return best


def _upload(rng, shape, np_dtype, dev) -> torch.Tensor:
    return torch.as_tensor(rng.normal(size=shape).astype(np_dtype),
                           device=dev)


def _i32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)


def _measure_gemm(block: int, np_dtype, repeats: int, rng,
                  dev) -> list[dict]:
    """Dense-queue samples: ``gemm_batch_scatter`` with T canvas tiles —
    exactly the launch the compiled dispatch issues for the DTQ."""
    m = k = n = 4 * block
    out = []
    for T in (1, 2, 4):
        x = _upload(rng, (T, m, k), np_dtype, dev)
        y = _upload(rng, (T, k, n), np_dtype, dev)
        rows = _i32(np.arange(T), dev)
        cols = _i32(np.zeros(T), dev)
        z = torch.zeros((T * m, n), dtype=torch.float32, device=dev)
        t = _time(lambda: ops.gemm_batch_scatter(x, y, rows, cols, z),
                  repeats=repeats, device=dev)
        out.append({"kind": "gemm", "macs": T * m * k * n, "t": t})
    return out


def _measure_spdmm(block: int, np_dtype, repeats: int, rng,
                   dev) -> list[dict]:
    """Sparse-queue samples: ``spdmm_fused`` over E stored-block entries —
    the per-stored-block cost the block-skip closed form needs."""
    B, bn, ncb = block, 4 * block, 4
    y = _upload(rng, (ncb * B, bn), np_dtype, dev)
    out = []
    for E in (4, 16, 48):
        pool = _upload(rng, (E, B, B), np_dtype, dev)
        ids = _i32(np.arange(E), dev)
        y_rows = _i32(np.arange(E) % ncb, dev)
        zeros = _i32(np.zeros(E), dev)
        first = _i32(np.ones(E), dev)
        t = _time(lambda: ops.spdmm_fused(
            pool, y, ids, y_rows, ids, zeros, first,
            block_size=B, bn=bn, m_pad=E * B),
            repeats=repeats, device=dev)
        out.append({"kind": "spdmm", "macs": E * B * B * bn, "t": t})
    return out


def _measure_spmm(block: int, np_dtype, repeats: int, rng,
                  dev) -> list[dict]:
    """Sparse-queue samples: ``spmm_fused`` over E (A block, Y block)
    triples."""
    B = block
    y_pool = _upload(rng, (8, B, B), np_dtype, dev)
    out = []
    for E in (4, 16, 48):
        pool = _upload(rng, (E, B, B), np_dtype, dev)
        ids = _i32(np.arange(E), dev)
        y_ids = _i32(np.arange(E) % 8, dev)
        zeros = _i32(np.zeros(E), dev)
        first = _i32(np.ones(E), dev)
        t = _time(lambda: ops.spmm_fused(
            pool, y_pool, ids, y_ids, ids, zeros, first,
            block_size=B, m_pad=E * B, n_pad=B),
            repeats=repeats, device=dev)
        out.append({"kind": "spmm", "macs": E * B * B * B, "t": t})
    return out


def _as_program(fn, dev):
    """``fn`` as a compiled program runs it: on a CUDA device captured once
    in a ``torch.cuda.CUDAGraph`` (:func:`repro_torch.device.capture_graph`)
    and returned as its replay; on the CPU, uncaptured."""
    if dev.type != "cuda":
        return fn
    graph, _ = capture_graph(fn, dev)
    return graph.replay


def _measure_pack(block: int, np_dtype, repeats: int, rng,
                  dev) -> list[dict]:
    """Activation-packer samples: ``pack_activation_stripes`` alone, as a
    compiled program runs it (:func:`_as_program`), swept over slot
    counts."""
    B = block
    out = []
    for S, R, C, cap in ((2, 4, 4, 4), (4, 4, 8, 8)):
        x = _upload(rng, (S * R * B, C * B), np_dtype, dev)
        caps = torch.full((S,), cap, dtype=torch.int32, device=dev)
        prog = _as_program(lambda: ops.pack_activation_stripes(
            x, block=B, n_stripes=S, slot_rows=R, n_block_cols=C,
            capacity=cap, eps=0.0, caps=caps), dev)
        t = _time(prog, repeats=repeats, device=dev)
        out.append({"kind": "pack", "slots": S * cap, "t": t})
    return out


def _measure_dispatch_floor(block: int, np_dtype, repeats: int, rng,
                            dev) -> float:
    """Per-launch dispatch floor: the smallest possible kernel's wall time
    is almost entirely launch overhead."""
    B = block
    x = _upload(rng, (1, B, B), np_dtype, dev)
    y = _upload(rng, (1, B, B), np_dtype, dev)
    z = torch.zeros((B, B), dtype=torch.float32, device=dev)
    idx = _i32(np.zeros(1), dev)
    return _time(lambda: ops.gemm_batch_scatter(x, y, idx, idx, z),
                 repeats=repeats, device=dev)


def _measure_membw(np_dtype, repeats: int, dev) -> float:
    """Effective memory bandwidth from a streaming op (``a + 1``: read and
    write one 1024 x 1024 buffer on the device)."""
    a = torch.as_tensor(np.zeros((1024, 1024), np_dtype), device=dev)
    t = _time(lambda: a + 1, repeats=repeats, device=dev)
    return 2.0 * a.numel() * a.element_size() / max(t, 1e-9)


def _fit_linear(samples: list[dict], xkey: str = "macs"
                ) -> tuple[float, float, float]:
    """Least-squares ``t = c0 + c1 * x`` with nonnegativity clamps; returns
    (c0, c1, relative RMS residual)."""
    t = np.array([s["t"] for s in samples], dtype=np.float64)
    x = np.array([s[xkey] for s in samples], dtype=np.float64)
    A = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    c0, c1 = float(coef[0]), float(coef[1])
    if c1 <= 0.0:
        # overhead-dominated sweep: the marginal slope is below measurement
        # noise.  Attribute the largest sample's whole time as marginal
        # cost — a conservative upper bound — rather than fitting a free
        # (or negative-cost) engine that the Analyzer would then always pick.
        i = int(np.argmax(x))
        logger.info("fit of %d samples: slope %.6g <= 0, clamped to the "
                    "largest sample's time per %s", len(samples), c1, xkey)
        c0, c1 = 0.0, float(t[i] / x[i])
    c0 = max(c0, 0.0)
    c1 = max(c1, 1e-18)
    pred = c0 + c1 * x
    resid = float(np.sqrt(np.mean(((pred - t) / np.maximum(t, 1e-12)) ** 2)))
    return c0, c1, resid


def _fit_logged(kind: str, samples: list[dict], xkey: str = "macs"):
    for s in samples:
        logger.info("sample %s %s=%d t=%.9g s", kind, xkey, s[xkey], s["t"])
    c0, c1, resid = _fit_linear(samples, xkey)
    logger.info("fit %s: c0 %.9g s, c1 %.9g s per %s, residual %.4g",
                kind, c0, c1, xkey, resid)
    return c0, c1, resid


def _roofline_crosscheck(np_dtype, membw_fit: float, repeats: int, dev
                         ) -> tuple[float, float, float]:
    """Time the port's ``gemm`` on a reference 256 x 256 x 256 product and
    compare its implied achieved bandwidth with the fitted one.  The
    reference costs the product from XLA's HLO; here the count is analytic:
    2 x 256^3 FLOP and three 256 x 256 operands of the dtype's size moved
    once (two read, one written)."""
    n = 256
    itemsize = int(np.dtype(np_dtype).itemsize)
    a = torch.zeros((n, n), dtype=torch.float32, device=dev)
    b = torch.zeros((n, n), dtype=torch.float32, device=dev)
    flops, nbytes = 2.0 * n ** 3, 3.0 * n * n * itemsize
    t = _time(lambda: ops.gemm(a, b, out_dtype=torch.float32),
              repeats=repeats, device=dev)
    implied_bw = nbytes / max(t, 1e-12)
    return flops, nbytes, implied_bw / max(membw_fit, 1e-9)


def calibrate(base: HardwareModel, *, block: int = 8,
              dtype: str = "float32", repeats: int = 2, seed: int = 0,
              device="cuda") -> CalibratedModel:
    """Run the microbenchmark sweep ONCE on ``device`` and fit a
    :class:`CalibratedModel`.

    The base model contributes its frequencies (rates are re-derived from
    the fitted marginal costs at those frequencies, so the closed forms
    keep their Table I shape) and its ``skip_block``; every rate, the
    dispatch overhead and the memory bandwidth are replaced by
    measurements.  ``n_sparse_units`` becomes 1 — the measured sparse path
    is one fused kernel stream.
    """
    dev = resolve_device(device)
    kind = device_kind(dev)
    np_dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    n0 = measurement_count()

    gemm_s = _measure_gemm(block, np_dtype, repeats, rng, dev)
    spdmm_s = _measure_spdmm(block, np_dtype, repeats, rng, dev)
    spmm_s = _measure_spmm(block, np_dtype, repeats, rng, dev)
    pack_s = _measure_pack(block, np_dtype, repeats, rng, dev)
    floor = _measure_dispatch_floor(block, np_dtype, repeats, rng, dev)
    membw = _measure_membw(np_dtype, repeats, dev)

    c0_g, c1_g, r_g = _fit_logged("gemm", gemm_s)
    c0_d, c1_d, r_d = _fit_logged("spdmm", spdmm_s)
    c0_m, c1_m, r_m = _fit_logged("spmm", spmm_s)
    _, c1_p, r_p = _fit_logged("pack", pack_s, xkey="slots")
    # the dispatch floor and the fitted intercepts estimate the same launch
    # bubble from different sweeps; take the most pessimistic
    overhead = max(floor, c0_g, c0_d, c0_m)
    logger.info("dispatch floor %.9g s, overhead %.9g s, mem_bw %.6g B/s",
                floor, overhead, membw)

    rl_flops, rl_bytes, rl_ratio = _roofline_crosscheck(
        np_dtype, membw, repeats, dev)

    return CalibratedModel(
        name=f"{base.name}+calib[{kind},b{block},{dtype}]",
        f_dense=base.f_dense,
        dense_macs_per_cycle=1.0 / (c1_g * base.f_dense),
        f_sparse=base.f_sparse,
        spdmm_macs_per_cycle=1.0 / (c1_d * base.f_sparse),
        spmm_macs_per_cycle=1.0 / (c1_m * base.f_sparse),
        n_sparse_units=1,
        mem_bw=membw,
        bytes_per_elem=int(np_dtype.itemsize),
        dispatch_overhead=overhead,
        skip_block=base.skip_block,
        fallback=False,
        calibrated=True,
        backend=kind,
        block=int(block),
        dtype=str(dtype),
        base=base.name,
        n_samples=measurement_count() - n0,
        gemm_s_per_mac=c1_g,
        spdmm_s_per_mac=c1_d,
        spmm_s_per_mac=c1_m,
        pack_s_per_slot=c1_p,
        fit_residual=float(max(r_g, r_d, r_m, r_p)),
        roofline_flops=rl_flops,
        roofline_bytes=rl_bytes,
        roofline_bw_ratio=rl_ratio,
    )


# ------------------------------------------------------------- persistence
SNAPSHOT_ENV = "REPRO_CALIBRATION_PATH"
SNAPSHOT_FORMAT = "repro_torch.calibration"


def save_snapshot(path: str, models: dict[tuple, CalibratedModel]) -> None:
    """Write a calibration snapshot: a pickle of {calibration_key:
    CalibratedModel} under the port's own format tag.  Atomic (a temp
    file moved into place), so a crash mid-save keeps the previous
    snapshot."""
    snapshot.atomic_dump(path, {"format": SNAPSHOT_FORMAT, "version": 1,
                                "models": dict(models)})


def load_snapshot(path: str) -> dict[tuple, CalibratedModel]:
    """Read a snapshot written by :func:`save_snapshot`.  Anything else —
    a JAX snapshot, another format or version — raises (the restricted
    reader refuses a foreign class before importing it)."""
    with open(path, "rb") as f:
        payload = snapshot.load(f)
    if not isinstance(payload, dict) or (
            payload.get("format") != SNAPSHOT_FORMAT):
        raise ValueError(f"{path} is not a {SNAPSHOT_FORMAT} snapshot")
    if payload.get("version") != 1:
        raise ValueError(
            f"unsupported calibration snapshot version "
            f"{payload.get('version')!r}")
    return dict(payload["models"])


def get_calibrated(cache, base: HardwareModel, *, block: int = 8,
                   dtype: str = "float32", repeats: int = 2,
                   snapshot_path: str | None = None,
                   device="cuda") -> CalibratedModel:
    """Get-or-measure the calibration for (device kind, block, dtype, base).

    Resolution order: the plan cache (``calib_hits`` — zero work), then the
    file snapshot (``snapshot_path`` or ``$REPRO_CALIBRATION_PATH`` — zero
    measurements, counted as a build), then a fresh :func:`calibrate` sweep
    whose result is written back to both.  An unusable snapshot is a
    logged cold start (``snapshot_errors``), never a raise.
    """
    dev = resolve_device(device)
    key = calibration_key(base, block, dtype, device=dev)

    def compute() -> CalibratedModel:
        path = snapshot_path or os.environ.get(SNAPSHOT_ENV)
        if path and os.path.exists(path):
            try:
                m = load_snapshot(path).get(key)
                if m is not None:
                    return m
            except Exception as exc:
                # unreadable (corrupt / truncated / foreign / wrong-version)
                # snapshot: a logged cold start, counted
                cache.stats.snapshot_errors += 1
                logger.warning(
                    "calibration snapshot %s unusable (%s: %s) — "
                    "re-measuring", path, type(exc).__name__, exc)
        m = calibrate(base, block=block, dtype=dtype, repeats=repeats,
                      device=dev)
        if path:
            try:
                snap = load_snapshot(path) if os.path.exists(path) else {}
            except Exception:
                snap = {}
            try:
                snap[key] = m
                save_snapshot(path, snap)
            except OSError:
                pass   # read-only FS: the in-process cache still has it
        return m

    return cache.calibration(key, compute)
