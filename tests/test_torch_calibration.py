"""The port's calibration subsystem on the CPU, against the JAX package:
the least-squares fit gives the reference's floats on the same samples,
``CalibratedModel`` has the reference's fields in order, engines planned
with the same calibrated values give equal task queues and descriptors,
the plan cache and file snapshots replay a restart with zero
measurements, and a snapshot written by the JAX package is refused as a
logged cold start.  Ports every case of ``tests/test_calibration.py``."""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import dispatch as jdispatch
from repro.core.engine import DynasparseEngine as JEngine
from repro.core.perfmodel import runtime_fallback as jfallback
from repro.core.primitives import SparseCOO as JCOO
from repro_torch.core import calibrate
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.engine import DynasparseEngine
from repro_torch.core.perfmodel import VCK5000, runtime_fallback
from repro_torch.core.plancache import PlanCache
from repro_torch.core.primitives import SparseCOO
from repro_torch.serving.cache import SharedPlanCache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_snapshot_env(monkeypatch):
    monkeypatch.delenv(calibrate.SNAPSHOT_ENV, raising=False)
    monkeypatch.delenv(jcal.SNAPSHOT_ENV, raising=False)


def _fake_model(base=None, module=calibrate, **over):
    base = base or runtime_fallback("cpu")
    kw = dict(
        name=f"{base.name}+calib[test,b8,float32]",
        f_dense=base.f_dense, dense_macs_per_cycle=1e3,
        f_sparse=base.f_sparse, spdmm_macs_per_cycle=1e3,
        spmm_macs_per_cycle=1e3, n_sparse_units=1, mem_bw=1e9,
        bytes_per_elem=4, dispatch_overhead=1e-4, skip_block=base.skip_block,
        calibrated=True, backend="cpu", block=8,
        dtype="float32", base=base.name, n_samples=14)
    kw.update(over)
    return module.CalibratedModel(**kw)


# ---------------------------------------------------------------- parity
def test_calibrated_model_fields_match_reference():
    names = [f.name for f in dataclasses.fields(calibrate.CalibratedModel)]
    assert names == [f.name for f in dataclasses.fields(jcal.CalibratedModel)]


SAMPLE_SETS = [
    [(2e-3 + 3e-9 * m, m) for m in (1e4, 5e4, 2e5, 1e6)],
    [(1e-3 - 1e-10 * m, m) for m in (1e4, 1e6)],                # clamp
    [(4.1e-5, 32768), (4.0e-5, 65536), (4.2e-5, 131072)],       # noisy floor
    [(6.1e-4, 8), (6.3e-4, 32)],
]


@pytest.mark.parametrize("samples", SAMPLE_SETS)
def test_fit_linear_equals_reference(samples):
    s = [{"t": t, "macs": m} for t, m in samples]
    assert calibrate._fit_linear(s) == jcal._fit_linear(s)


def test_runtime_fallback_cuda_and_reference_table():
    cuda = runtime_fallback("cuda")
    assert cuda.name == "cuda-fallback" and cuda.fallback
    assert cuda.f_dense * cuda.dense_macs_per_cycle == pytest.approx(67e12 / 2)
    assert cuda.mem_bw == 3.35e12 and cuda.f_dense == 1.98e9
    for kind in ("tpu", "cpu"):
        assert (dataclasses.asdict(runtime_fallback(kind))
                == dataclasses.asdict(jfallback(kind)))


def _graph_pair(seed, n=64, deg=4):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    coo = np.unique(np.stack([rows, cols], 1), axis=0)
    r, c = coo[:, 0].astype(np.int32), coo[:, 1].astype(np.int32)
    v = rng.uniform(0.1, 1.0, size=len(coo)).astype(np.float32)
    return rng, (JCOO((n, n), jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                      tag="adjacency"),
                 SparseCOO((n, n), torch.as_tensor(r), torch.as_tensor(c),
                           torch.as_tensor(v), tag="adjacency"))


@pytest.mark.parametrize("rates", [(1e3, 1e3, 1e3), (1e4, 30.0, 5.0),
                                   (2.0, 1e4, 1e4)])
def test_engine_planned_with_calibrated_values_equals_reference(rates):
    """The same calibrated values in both packages: equal task queues (every
    task field) and equal compiled-dispatch descriptors."""
    dense, spdmm_r, spmm_r = rates
    over = dict(dense_macs_per_cycle=dense, spdmm_macs_per_cycle=spdmm_r,
                spmm_macs_per_cycle=spmm_r)
    tm = _fake_model(runtime_fallback("cpu"), **over)
    jm = _fake_model(jfallback("cpu"), module=jcal, **over)
    rng, (jadj, tadj) = _graph_pair(3)
    y = rng.normal(size=(64, 16)).astype(np.float32)
    y[:, :8] *= rng.uniform(size=(64, 8)) < 0.1
    je = JEngine(jfallback("cpu"), tile_m=16, tile_n=8, literal=True,
                 calibration=jm)
    te = DynasparseEngine(runtime_fallback("cpu"), tile_m=16, tile_n=8,
                          literal=True, calibration=tm, device="cpu")
    jp, tp = je.plan(jadj, y), te.plan(tadj, y)
    assert ([dataclasses.asdict(t) for t in tp.stq]
            == [dataclasses.asdict(t) for t in jp.stq])
    assert ([dataclasses.asdict(t) for t in tp.dtq]
            == [dataclasses.asdict(t) for t in jp.dtq])
    assert tp.stq or tp.dtq
    jd, td = je.dispatch_for(jp, jadj), te.dispatch_for(tp, tadj)
    assert dataclasses.asdict(td.geom) == dataclasses.asdict(jd.geom)
    assert sorted(td.arrays) == sorted(jd.arrays)
    for k in jd.arrays:
        np.testing.assert_array_equal(td.arrays[k].numpy(),
                                      np.asarray(jd.arrays[k]), err_msg=k)
    assert td.fingerprint == jd.fingerprint
    assert (tdispatch.plan_digest(tp, 8) == jdispatch.plan_digest(jp, 8))


# ---------------------------------------------------- the reference's cases
def test_fit_linear_recovers_synthetic_coefficients():
    c0, c1 = 2e-3, 3e-9
    samples = [{"t": c0 + c1 * m, "macs": m}
               for m in (1e4, 5e4, 2e5, 1e6)]
    f0, f1, resid = calibrate._fit_linear(samples)
    assert f0 == pytest.approx(c0, rel=1e-6)
    assert f1 == pytest.approx(c1, rel=1e-6)
    assert resid < 1e-6


def test_fit_linear_clamps_nonnegative():
    samples = [{"t": 1e-3 - 1e-10 * m, "macs": m} for m in (1e4, 1e6)]
    c0, c1, _ = calibrate._fit_linear(samples)
    assert c0 >= 0.0 and c1 > 0.0


def test_get_calibrated_caches_and_counts(monkeypatch):
    calls = []
    fake = _fake_model()
    monkeypatch.setattr(calibrate, "calibrate",
                        lambda *a, **k: calls.append(1) or fake)
    cache = PlanCache()
    base = runtime_fallback("cpu")
    m1 = calibrate.get_calibrated(cache, base, block=8, device="cpu")
    m2 = calibrate.get_calibrated(cache, base, block=8, device="cpu")
    assert m1 is fake and m2 is fake
    assert len(calls) == 1
    assert cache.stats.calib_builds == 1 and cache.stats.calib_hits == 1
    assert cache.calibration_count() == 1


def test_calibration_key_binds_backend_block_dtype():
    base = runtime_fallback("cpu")
    k = calibrate.calibration_key(base, 8, "float32", device="cpu")
    assert k == ("cpu", 8, "float32", base.name)
    assert k != calibrate.calibration_key(base, 16, "float32", device="cpu")
    assert k != calibrate.calibration_key(VCK5000, 8, "float32", device="cpu")


def test_snapshot_file_roundtrip_and_replay(tmp_path, monkeypatch):
    base = runtime_fallback("cpu")
    key = calibrate.calibration_key(base, 8, "float32", device="cpu")
    fake = _fake_model(base)
    path = str(tmp_path / "calib" / "snapshot.pkl")
    calibrate.save_snapshot(path, {key: fake})
    loaded = calibrate.load_snapshot(path)
    assert loaded[key] == fake

    def boom(*a, **k):
        raise AssertionError("measured despite snapshot")
    monkeypatch.setattr(calibrate, "calibrate", boom)
    cache = PlanCache()
    n0 = calibrate.measurement_count()
    m = calibrate.get_calibrated(cache, base, block=8, snapshot_path=path,
                                 device="cpu")
    assert m == fake
    assert calibrate.measurement_count() == n0
    assert cache.stats.calib_builds == 1   # built from file, not measured


def test_snapshot_env_var_and_write_back(tmp_path, monkeypatch):
    base = runtime_fallback("cpu")
    fake = _fake_model(base)
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: fake)
    path = str(tmp_path / "snapshot.pkl")
    monkeypatch.setenv(calibrate.SNAPSHOT_ENV, path)
    m = calibrate.get_calibrated(PlanCache(), base, block=8, device="cpu")
    assert m is fake
    key = calibrate.calibration_key(base, 8, "float32", device="cpu")
    assert calibrate.load_snapshot(path)[key] == fake


def test_snapshot_rejects_unknown_version(tmp_path):
    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps({"format": calibrate.SNAPSHOT_FORMAT,
                                   "version": 99, "models": {}}))
    with pytest.raises(ValueError, match="snapshot version"):
        calibrate.load_snapshot(str(path))


def test_shared_cache_restart_replays_zero_measurements(
        tmp_path, monkeypatch):
    base = runtime_fallback("cpu")
    fake = _fake_model(base)
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: fake)
    cache = SharedPlanCache(device="cpu")
    calibrate.get_calibrated(cache, base, block=8, device="cpu")
    assert cache.calibration_count() == 1
    snap = str(tmp_path / "cache.pkl")
    cache.save(snap)

    def boom(*a, **k):
        raise AssertionError("measured despite warm cache")
    monkeypatch.setattr(calibrate, "calibrate", boom)
    fresh = SharedPlanCache(device="cpu")
    fresh.load(snap)
    assert fresh.calibration_count() == 1
    n0 = calibrate.measurement_count()
    m = calibrate.get_calibrated(fresh, base, block=8, device="cpu")
    assert m == fake
    assert calibrate.measurement_count() == n0
    assert fresh.stats.calib_builds == 0 and fresh.stats.calib_hits == 1


def _toy_coo(rng, n=64, deg=4):
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=n * deg)
    coo = np.unique(np.stack([rows, cols], 1), axis=0)
    return SparseCOO(shape=(n, n),
                     rows=torch.as_tensor(coo[:, 0].astype(np.int32)),
                     cols=torch.as_tensor(coo[:, 1].astype(np.int32)),
                     vals=torch.ones(len(coo), dtype=torch.float32))


def test_engine_auto_calibration_gates_on_fallback(monkeypatch):
    """Analytical models are never calibrated away; fallback models resolve
    through get_calibrated exactly once per engine, on the engine's
    device."""
    fake = _fake_model()
    calls = []
    monkeypatch.setattr(calibrate, "calibrate",
                        lambda *a, **k: calls.append(k) or fake)

    eng = DynasparseEngine(device="cpu")            # VCK5000: analytical
    assert eng.runtime_hw() is VCK5000
    assert not calls

    fb = runtime_fallback("cpu")
    eng2 = DynasparseEngine(fb, device="cpu")
    assert eng2.runtime_hw() is fake
    assert eng2.runtime_hw() is fake                # resolved once
    assert len(calls) == 1 and calls[0]["device"] == torch.device("cpu")
    assert eng2.cache.stats.calib_builds == 1

    eng3 = DynasparseEngine(fb, calibration="off", device="cpu")
    assert eng3.runtime_hw() is fb

    eng4 = DynasparseEngine(fb, calibration=VCK5000, device="cpu")
    assert eng4.runtime_hw() is VCK5000


def test_engine_plan_key_uses_effective_model(monkeypatch):
    fake = _fake_model()
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: fake)
    rng = np.random.default_rng(0)
    adj = _toy_coo(rng)
    y = rng.normal(size=(64, 16)).astype(np.float32)
    fb = runtime_fallback("cpu")
    cache = PlanCache()
    eng_cal = DynasparseEngine(fb, tile_m=16, tile_n=8, literal=True,
                               cache=cache, device="cpu")
    eng_off = DynasparseEngine(fb, tile_m=16, tile_n=8, literal=True,
                               cache=cache, calibration="off", device="cpu")
    eng_cal.plan(adj, y)
    eng_off.plan(adj, y)
    assert cache.plan_count() == 2


# ----------------------------------------------------- the real sweep
def test_calibrate_measures_the_plain_kernels_on_the_cpu():
    """The reference's sweep, run for real through the kernels' plain
    versions: 14 timed samples, a model keyed on the CPU, positive rates,
    and the analytic cross-check count of the 256^3 product."""
    n0 = calibrate.measurement_count()
    m = calibrate.calibrate(runtime_fallback("cpu"), device="cpu")
    assert calibrate.measurement_count() - n0 == m.n_samples == 14
    assert m.backend == "cpu" and m.calibrated and not m.fallback
    assert m.name == "cpu-fallback+calib[cpu,b8,float32]"
    for f in ("dense_macs_per_cycle", "spdmm_macs_per_cycle",
              "spmm_macs_per_cycle", "mem_bw", "dispatch_overhead",
              "pack_s_per_slot"):
        assert getattr(m, f) > 0.0, f
    assert m.roofline_flops == 2.0 * 256 ** 3
    assert m.roofline_bytes == 3.0 * 256 * 256 * 4


# ------------------------------------------------- JAX snapshots refused
def test_jax_calibration_snapshot_is_a_logged_cold_start(tmp_path,
                                                         monkeypatch):
    base = runtime_fallback("cpu")
    path = str(tmp_path / "jax_calib.pkl")
    jcal.save_snapshot(path, {calibrate.calibration_key(
        base, 8, "float32", device="cpu"): _fake_model(jfallback("cpu"),
                                                       module=jcal)})
    with pytest.raises(pickle.UnpicklingError, match="repro.core"):
        calibrate.load_snapshot(path)
    fake = _fake_model(base)
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: fake)
    cache = PlanCache()
    m = calibrate.get_calibrated(cache, base, block=8, snapshot_path=path,
                                 device="cpu")
    assert m is fake and cache.stats.snapshot_errors == 1


REFUSE_SCRIPT = r"""
import sys
from repro_torch.core import calibrate
from repro_torch.core.plancache import PlanCache
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.serving.cache import SharedPlanCache
calibrate.calibrate = lambda *a, **k: "measured"
cache = PlanCache()
got = calibrate.get_calibrated(cache, runtime_fallback("cpu"),
                               snapshot_path=sys.argv[1], device="cpu")
shared = SharedPlanCache(device="cpu")
manifest = shared.load(sys.argv[2])
loaded = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith("repro."))
print(got, cache.stats.snapshot_errors, manifest["cold_start"],
      shared.stats.snapshot_errors, len(shared), loaded)
"""


def test_jax_snapshots_refused_before_importing_the_reference(tmp_path):
    """In a process that has only the port loaded, reading a calibration
    snapshot and a plan-cache snapshot written by the JAX package imports
    neither ``jax`` nor ``repro``: both are logged cold starts."""
    from repro.models import gnn as jgnn
    from repro.serving.cache import SharedPlanCache as JShared

    calib = str(tmp_path / "calib.pkl")
    jcal.save_snapshot(calib, {("cpu", 8, "float32", "cpu-fallback"):
                               _fake_model(jfallback("cpu"), module=jcal)})
    _, (jadj, _) = _graph_pair(5)
    jc = JShared()
    je = JEngine(tile_m=16, tile_n=8, literal=True, cache=jc)
    jgnn.run_inference("GCN", je, jadj,
                       jnp.ones((64, 12), jnp.float32),
                       jgnn.init_params("GCN", 12, 8, 5))
    plans = str(tmp_path / "plans.pkl")
    jc.save(plans)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", REFUSE_SCRIPT, calib, plans], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["measured", "1", "True", "1", "0", "[]"]
