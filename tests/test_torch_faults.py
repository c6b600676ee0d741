"""The port's degraded-mode serving on the CPU: seeded fault injection
(firing at the same probe indices as the JAX package's injector for a
given seed), the compiled → eager → bisect → retry → quarantine ladder,
per-request deadlines, the drift-churn circuit breaker, dispatch-worker
health and corrupt-snapshot cold starts.  Ports every case of
``tests/test_faults.py``.

- ISOLATION: a poison request fails ALONE; every fault-free neighbour's
  logits are BIT-EQUAL (``torch.equal``) to a fault-free port run.
- LIVENESS: under chaos at every instrumented site, every submitted
  request resolves — logits or a structured error, never a hang.  Every
  site the single-device port probes fires at least once.
- DURABILITY: a truncated / garbage / wrong-version snapshot degrades to a
  logged cold start, and a fault mid-save never clobbers the previous
  snapshot.
"""
import asyncio
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro.serving import FaultInjector as JFaultInjector
from repro.serving import InjectedFault as JInjectedFault
from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.core import calibrate
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.core.plancache import PlanCache
from repro_torch.distributed.fault import FaultMonitor
from repro_torch.models import gnn
from repro_torch.serving import (DeadlineExceeded, FaultInjector,
                                 InjectedFault, ServingConfig, ServingEngine,
                                 SharedPlanCache, SketchConfig)
from repro_torch.serving.faults import KNOWN_SITES

RNG = np.random.default_rng(11)
CPU = "cpu"
# probed only by mesh engines (the serving engine below has none)
SHARD_SITES = {"shard_lower", "shard_exec"}


def _rand_graph(n=80, nnz=240, seed=5):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    return SparseCOO((n, n), torch.as_tensor((flat // n).astype(np.int32)),
                     torch.as_tensor((flat % n).astype(np.int32)),
                     torch.as_tensor(np.abs(rng.normal(size=nnz))
                                     .astype(np.float32)),
                     tag="adjacency")


ADJ = _rand_graph()
# hidden/out widths are MULTIPLES of tile_n (8) so no kernel column tile
# straddles a request boundary: per-request results are then
# BIT-independent of batch composition (the isolation gate below)
PARAMS = gnn.init_params("GCN", 12, 8, 8, device=CPU)


def _feats(i, n=80, d=12):
    rng = np.random.default_rng(1000 + i)
    return rng.normal(size=(n, d)).astype(np.float32)


def _serving(*, faults=None, max_batch=4, max_retries=1, drift=None,
             timeout=None, backoff=0.0, breaker=(3, 60.0, 30.0)):
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True,
                           cache=SharedPlanCache(device=CPU), device=CPU)
    # activation_skip off: the block-skip route's capacity/overflow decision
    # is global to the kernel, so a neighbour could flip the whole kernel
    # between routes — composition-dependent bits
    cfg = ServingConfig(
        max_batch=max_batch, sketch=SketchConfig(threshold=drift),
        activation_skip=False,
        max_retries=max_retries, retry_backoff_s=backoff,
        request_timeout=timeout, breaker_threshold=breaker[0],
        breaker_window_s=breaker[1], breaker_cooldown_s=breaker[2],
        faults=faults)
    srv = ServingEngine("GCN", PARAMS, engine=eng, config=cfg)
    srv.register_graph("g", ADJ)
    return srv


def _warm(srv, max_batch=4):
    """One FIXED warmup burst, so the reference run and a chaos run compile
    the identical program; offsets request ids by ``max_batch``."""
    srv.serve(("g", _feats(900 + j)) for j in range(max_batch))


def _reference(n_requests=8, max_batch=4, warm=True):
    srv = _serving(max_batch=max_batch)
    try:
        if warm:
            _warm(srv, max_batch)
        return [z.clone() for z in
                srv.serve(("g", _feats(i)) for i in range(n_requests))]
    finally:
        srv.close()


_REF8_CACHE: list = []


def ref8():
    if not _REF8_CACHE:
        _REF8_CACHE.append(_reference(8))
    return _REF8_CACHE[0]


def _ref_logits(h):
    return gnn.run_reference("GCN", ADJ, torch.as_tensor(h), PARAMS)


# ---------------------------------------------------- parity with the JAX side
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_injector_fires_at_the_reference_probe_indices(seed):
    """Same seed, same arms, same probe sequence: the port's injector fires
    at exactly the reference's probe indices (per-site streams seeded from
    ``(seed, crc32(site))``)."""
    def fired(cls, fault):
        fi = (cls(seed=seed).arm("plan", rate=0.3)
              .arm("execute", rate=0.6, after=3, count=7)
              .arm("request", rate=0.5, match="req:1"))
        out = []
        for i in range(200):
            site = ("plan", "execute", "request")[i % 3]
            try:
                fi.probe(site, detail=f"req:{i % 20};")
            except fault as exc:
                out.append((site, exc.n))
        return out, fi.summary()

    assert fired(FaultInjector, InjectedFault) == fired(JFaultInjector,
                                                        JInjectedFault)
    assert KNOWN_SITES == __import__(
        "repro.serving.faults", fromlist=["KNOWN_SITES"]).KNOWN_SITES


# ------------------------------------------------------------- injector
def test_injector_rejects_unknown_site_and_bad_rate():
    fi = FaultInjector(seed=0)
    with pytest.raises(ValueError, match="unknown fault site"):
        fi.arm("warp_core")
    with pytest.raises(ValueError, match="rate"):
        fi.arm("plan", rate=1.5)


def test_injector_fires_deterministically_per_seed():
    def pattern(seed, extra_probes=0):
        fi = FaultInjector(seed=seed).arm("plan", rate=0.4)
        for _ in range(extra_probes):
            fi.probe("execute")
        fired = []
        for i in range(64):
            try:
                fi.probe("plan", detail=f"k{i}")
                fired.append(0)
            except InjectedFault:
                fired.append(1)
        return fired

    a = pattern(7)
    assert a == pattern(7)
    assert a == pattern(7, extra_probes=50)
    assert a != pattern(8)
    assert 0 < sum(a) < 64


def test_injector_count_after_match_and_disarm():
    fi = FaultInjector(seed=0).arm("execute", count=2, after=1)
    fires = 0
    for _ in range(6):
        try:
            fi.probe("execute")
        except InjectedFault:
            fires += 1
    assert fires == 2
    assert fi.summary()["execute"]["probes"] == 6
    assert fi.summary()["execute"]["fired"] == 2

    fi = FaultInjector(seed=0).arm("request", match="req:3")
    fi.probe("request", detail="req:1")
    with pytest.raises(InjectedFault) as ei:
        fi.probe("request", detail="req:3")
    assert ei.value.site == "request" and "req:3" in ei.value.detail
    fi.disarm("request")
    fi.probe("request", detail="req:3")
    assert fi.total_fired == 1


# ----------------------------------------------------- poison isolation
@pytest.mark.parametrize("poison", [0, 3, 5, 7])
def test_poison_request_fails_alone_neighbours_bit_equal(poison):
    fi = FaultInjector(seed=1).arm("request", rate=1.0,
                                   match=f"req:{4 + poison};")
    srv = _serving(faults=fi)
    _warm(srv)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert len(outs) == 8
    for i, z in enumerate(outs):
        if i == poison:
            assert isinstance(z, InjectedFault)
        else:
            assert not isinstance(z, Exception)
            assert torch.equal(z, ref8()[i])
    assert srv.stats.quarantined == 1
    assert srv.stats.errors == 1
    bad = [r for r in srv.stats.requests if r.error is not None]
    assert len(bad) == 1 and "injected fault" in bad[0].error
    srv.close()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_property_random_poison_sets_never_fail_neighbours(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 9))
    max_batch = int(rng.integers(2, 5))
    poisons = set(rng.choice(n, size=int(rng.integers(1, 3)),
                             replace=False).tolist())
    fi = FaultInjector(seed=seed)
    for p in poisons:
        fi.arm("request", rate=1.0, match=f"req:{max_batch + p};")
    ref = _reference(n, max_batch=max_batch)
    srv = _serving(faults=fi, max_batch=max_batch)
    _warm(srv, max_batch)
    outs = srv.serve((("g", _feats(i)) for i in range(n)),
                     return_exceptions=True)
    failed = {i for i, z in enumerate(outs) if isinstance(z, Exception)}
    assert failed == poisons
    for i, z in enumerate(outs):
        if i not in poisons:
            assert torch.equal(z, ref[i])
    srv.close()


# ----------------------------------------------------- degradation ladder
def test_transient_batch_fault_recovers_bit_equal():
    fi = FaultInjector(seed=3).arm("dispatch", rate=1.0, count=2, after=1)
    srv = _serving(faults=fi, max_retries=2)
    _warm(srv)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert not any(isinstance(z, Exception) for z in outs)
    assert srv.stats.errors == 0
    assert srv.stats.bisections + srv.stats.retries >= 1
    for i, z in enumerate(outs):
        assert torch.equal(z, ref8()[i])
    srv.close()


def test_compiled_fault_degrades_to_eager_batch():
    fi = FaultInjector(seed=2).arm("compiled", rate=1.0, count=1)
    srv = _serving(faults=fi)
    _warm(srv)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert not any(isinstance(z, Exception) for z in outs)
    assert srv.stats.degraded_batches == 1
    assert fi.summary()["compiled"]["fired"] == 1
    for i, z in enumerate(outs):
        np.testing.assert_allclose(z.numpy(), ref8()[i].numpy(),
                                   rtol=1e-4, atol=1e-5)
    srv.close()


@pytest.mark.parametrize("site", sorted(KNOWN_SITES
                                        - {"snapshot_save", "snapshot_load"}))
def test_chaos_every_site_every_request_resolves(site):
    """A bounded fault at one instrumented site, no pre-warm: every request
    resolves and is recorded, successes stay numerically correct, and
    every site the single-device port probes actually fires."""
    fi = FaultInjector(seed=5).arm(site, rate=1.0, count=2)
    srv = _serving(faults=fi, max_retries=2)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert len(outs) == 8
    for i, z in enumerate(outs):
        if not isinstance(z, Exception):
            np.testing.assert_allclose(z.numpy(), ref8()[i].numpy(),
                                       rtol=1e-4, atol=1e-5)
    assert len(srv.stats.requests) == 8
    if site not in SHARD_SITES:
        assert fi.summary()[site]["fired"] >= 1
    srv.close()


@pytest.mark.parametrize("site", sorted(SHARD_SITES))
def test_shard_sites_raise_at_their_site(site):
    """On a 4-shard mesh engine an armed ``shard_lower`` fault raises from
    the sharded lowering and ``shard_exec`` from the sharded execute; the
    next call (count spent) lowers / runs and equals the unsharded
    engine's result.  Mesh serving (``n_devices=1``) under the same fault
    resolves every request."""
    from repro_torch.launch.mesh import DataMesh

    fi = FaultInjector(seed=3).arm(site, rate=1.0, count=1)
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True, device=CPU,
                           mesh=DataMesh((CPU,) * 4), faults=fi)
    h = torch.as_tensor(_feats(0)[:, :8].copy())
    with pytest.raises(InjectedFault) as err:
        eng.matmul(ADJ, h)
    assert err.value.site == site
    assert eng.cache.sharded_count() == (0 if site == "shard_lower" else 1)
    z, _ = eng.matmul(ADJ, h)
    plain = DynasparseEngine(tile_m=16, tile_n=8, literal=True, device=CPU)
    assert torch.equal(z, plain.matmul(ADJ, h)[0])
    assert fi.summary()[site]["fired"] == 1

    fi = FaultInjector(seed=3).arm(site, rate=1.0, count=1)
    srv = ServingEngine("GCN", PARAMS, cache=SharedPlanCache(device=CPU),
                        config=ServingConfig(max_batch=4, n_devices=1,
                                             activation_skip=False,
                                             faults=fi))
    srv.register_graph("g", ADJ)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert fi.summary()[site]["fired"] == 1
    for i, z in enumerate(outs):
        assert not isinstance(z, Exception), z
        np.testing.assert_allclose(z.numpy(), ref8()[i].numpy(),
                                   rtol=1e-4, atol=1e-5)
    srv.close()


def test_activation_pack_site_fires_on_the_block_skip_route():
    """The ``pack`` probe of the activation lowering: with the block-skip
    route on, a fault there during the warmup compile degrades that batch
    and every request still resolves correctly."""
    fi = FaultInjector(seed=8).arm("pack", rate=1.0, count=1,
                                   match="act:")
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True,
                           cache=SharedPlanCache(device=CPU), device=CPU)
    params = gnn.init_params("GIN", 12, 8, 8, device=CPU)
    srv = ServingEngine("GIN", params, engine=eng,
                        config=ServingConfig(max_batch=2, max_retries=2,
                                             faults=fi))
    srv.register_graph("g", ADJ)
    feats = [_feats(i) * (np.random.default_rng(i).uniform(size=(80, 12))
                          < 0.2) for i in range(4)]
    outs = srv.serve((("g", h) for h in feats), return_exceptions=True)
    assert fi.summary()["pack"]["fired"] == 1
    for h, z in zip(feats, outs):
        assert not isinstance(z, Exception)
        ref = gnn.run_reference("GIN", ADJ, torch.as_tensor(h), params)
        np.testing.assert_allclose(z.numpy(), ref.numpy(), rtol=1e-4,
                                   atol=1e-4)
    srv.close()


def test_chaos_mixed_sites_all_resolve():
    fi = (FaultInjector(seed=6)
          .arm("plan", rate=0.3, count=2)
          .arm("execute", rate=0.3, count=2)
          .arm("compiled", rate=1.0, count=1)
          .arm("request", rate=1.0, match="req:2;"))
    srv = _serving(faults=fi, max_retries=3)
    outs = srv.serve((("g", _feats(i)) for i in range(8)),
                     return_exceptions=True)
    assert len(outs) == 8
    assert isinstance(outs[2], InjectedFault)
    for i, z in enumerate(outs):
        if i != 2 and not isinstance(z, Exception):
            np.testing.assert_allclose(z.numpy(), ref8()[i].numpy(),
                                       rtol=1e-4, atol=1e-5)
    assert len(srv.stats.requests) == 8
    srv.close()


# ------------------------------------------------------------- deadlines
def test_deadline_fails_straggling_request_with_structured_error():
    fi = FaultInjector(seed=4).arm("dispatch", rate=1.0, count=1,
                                   delay_s=1.2)
    srv = _serving(faults=fi, timeout=0.3)
    outs = srv.serve((("g", _feats(i)) for i in range(2)),
                     return_exceptions=True)
    assert all(isinstance(z, DeadlineExceeded) for z in outs)
    assert srv.stats.deadline_expired == 2
    recorded = [r for r in srv.stats.requests
                if r.error and "DeadlineExceeded" in r.error]
    assert len(recorded) == 2
    time.sleep(1.3)
    srv.close()


def test_infer_without_deadline_still_works():
    srv = _serving()

    async def go():
        return await srv.infer("g", _feats(0))

    z = asyncio.run(go())
    assert torch.equal(z, ref8()[0])
    srv.close()


# -------------------------------------------------------- circuit breaker
def test_breaker_bounds_drift_recompile_churn():
    sparse_h = (RNG.normal(size=(80, 12)) *
                (RNG.uniform(size=(80, 12)) < 0.03)).astype(np.float32)
    dense_h = RNG.normal(size=(80, 12)).astype(np.float32)
    flips = [sparse_h if i % 2 == 0 else dense_h for i in range(12)]

    srv = _serving(max_batch=1, drift=0.25, breaker=(2, 60.0, 60.0))
    outs = srv.serve(("g", h) for h in flips)
    assert srv.stats.breaker_trips >= 1
    assert srv.stats.compile_invalidations <= 2
    for h, z in zip(flips, outs):
        np.testing.assert_allclose(z.numpy(), _ref_logits(h).numpy(),
                                   rtol=1e-3, atol=1e-3)
    assert srv.dispatch_stats()["breaker_trips"] == srv.stats.breaker_trips
    srv.close()


# ------------------------------------------------------------ health wire
def test_dispatch_stats_health_surface():
    srv = _serving()
    srv.serve([("g", _feats(i)) for i in range(4)])
    health = srv.dispatch_stats()["health"]
    assert "dispatch-0" in health["hosts"]
    w = health["hosts"]["dispatch-0"]
    assert w["steps"] >= 1 and w["median_step_s"] > 0.0
    assert health["dead"] == [] and "dispatch-0" in health["healthy"]
    srv.close()


def test_fault_monitor_snapshot_flags_dead_and_stragglers():
    mon = FaultMonitor(["a", "b", "x"], timeout=10.0, straggler_factor=2.0)
    t = 100.0
    for i in range(6):
        mon.heartbeat("a", step_time=1.0, now=t + i)
        mon.heartbeat("x", step_time=1.0, now=t + i)
        mon.heartbeat("b", step_time=5.0, now=t + i)
    snap = mon.snapshot(now=t + 6)
    assert snap["stragglers"] == ["b"]
    assert snap["hosts"]["a"]["median_step_s"] == 1.0
    snap = mon.snapshot(now=t + 50)
    assert set(snap["dead"]) == {"a", "b", "x"}
    mon.ensure_host("c", now=t + 50)
    assert "c" in mon.snapshot(now=t + 50)["hosts"]


# ------------------------------------------------- snapshot robustness
def _populated_cache():
    cache = SharedPlanCache(device=CPU)
    eng = DynasparseEngine(tile_m=16, tile_n=8, literal=True, cache=cache,
                           device=CPU)
    gnn.run_inference("GCN", eng, ADJ, _feats(0), PARAMS, device=CPU)
    cache.register_graph("g", ADJ)
    return cache


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_truncated_snapshot_cold_starts(tmp_path, seed):
    cache = _populated_cache()
    path = os.fspath(tmp_path / "snap.pkl")
    cache.save(path)
    blob = open(path, "rb").read()
    rng = np.random.default_rng(seed)
    for cut in rng.integers(0, len(blob), size=4):
        with open(path, "wb") as f:
            f.write(blob[:int(cut)])
        fresh = SharedPlanCache(device=CPU)
        manifest = fresh.load(path)
        assert manifest["cold_start"] is True
        assert manifest["entries"] == 0 and len(fresh) == 0
        assert fresh.stats.snapshot_errors == 1
        assert "error" in manifest


def test_garbage_and_wrong_pickle_snapshot_cold_starts(tmp_path):
    path = os.fspath(tmp_path / "snap.pkl")
    with open(path, "wb") as f:
        f.write(b"\x00not a pickle at all" * 7)
    fresh = SharedPlanCache(device=CPU)
    assert fresh.load(path)["cold_start"] is True
    assert fresh.stats.snapshot_errors == 1

    with open(path, "wb") as f:
        pickle.dump(["not", "a", "dict"], f)
    manifest = fresh.load(path)
    assert manifest["cold_start"] is True
    assert fresh.stats.snapshot_errors == 2
    assert "not a dict" in manifest["error"]

    missing = os.fspath(tmp_path / "never_written.pkl")
    assert fresh.load(missing)["cold_start"] is True
    assert fresh.stats.snapshot_errors == 3


def test_version_flip_snapshot_cold_starts_with_message(tmp_path):
    cache = _populated_cache()
    path = os.fspath(tmp_path / "snap.pkl")
    cache.save(path)
    payload = pickle.load(open(path, "rb"))
    payload["version"] = 999
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    fresh = SharedPlanCache(device=CPU)
    manifest = fresh.load(path)
    assert manifest["cold_start"] is True
    assert "snapshot version" in manifest["error"]
    assert fresh.stats.snapshot_errors == 1


def test_fault_during_save_leaves_previous_snapshot_intact(tmp_path):
    cache = _populated_cache()
    path = os.fspath(tmp_path / "snap.pkl")
    cache.save(path)
    good = open(path, "rb").read()

    cache.faults = FaultInjector(seed=9).arm("snapshot_save", rate=1.0)
    with pytest.raises(InjectedFault):
        cache.save(path)
    assert open(path, "rb").read() == good
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []
    cache.faults = None

    fresh = SharedPlanCache(device=CPU)
    manifest = fresh.load(path)
    assert manifest["cold_start"] is False
    assert manifest["entries"] > 0


def test_injected_snapshot_load_fault_degrades_to_cold_start(tmp_path):
    cache = _populated_cache()
    path = os.fspath(tmp_path / "snap.pkl")
    cache.save(path)
    fresh = SharedPlanCache(device=CPU)
    fresh.faults = FaultInjector(seed=9).arm("snapshot_load", rate=1.0,
                                             count=1)
    manifest = fresh.load(path)
    assert manifest["cold_start"] is True
    assert fresh.stats.snapshot_errors == 1
    assert fresh.load(path)["cold_start"] is False


def test_corrupt_calibration_snapshot_remeasures(tmp_path, monkeypatch):
    monkeypatch.delenv(calibrate.SNAPSHOT_ENV, raising=False)
    path = os.fspath(tmp_path / "calib.pkl")
    with open(path, "wb") as f:
        f.write(b"\x80garbage" * 11)
    fake = object()
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: fake)
    cache = PlanCache()
    m = calibrate.get_calibrated(cache, runtime_fallback("cpu"), block=8,
                                 snapshot_path=path, device=CPU)
    assert m is fake
    assert cache.stats.snapshot_errors == 1


def test_calibration_save_snapshot_is_atomic(tmp_path):
    base = runtime_fallback("cpu")
    key = calibrate.calibration_key(base, 8, "float32", device=CPU)
    path = os.fspath(tmp_path / "calib.pkl")
    calibrate.save_snapshot(path, {key: "sentinel"})
    good = open(path, "rb").read()

    class Boom:
        def __reduce__(self):
            raise RuntimeError("mid-pickle crash")

    with pytest.raises(RuntimeError):
        calibrate.save_snapshot(path, {key: Boom()})
    assert open(path, "rb").read() == good
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []
