"""The port's SharedPlanCache on the CPU: byte-accounted LRU eviction,
multi-graph keying, persistence round-trips that re-upload to the cache's
device (the activation dispatch's ``act_caps`` included), the lazy-densify
structure entries, the same cache keys as the JAX package's cache after the
same inference, a JAX package snapshot refused as a logged cold start, and
the sharded dispatch of a mesh bigger than this host skipped on load.
Ports every case of ``tests/test_shared_cache.py``."""
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DynasparseEngine as JEngine, SparseCOO as JCOO
from repro.models import gnn as jgnn
from repro.serving import SharedPlanCache as JShared
from repro_torch import snapshot
from repro_torch.core import DynasparseEngine, SparseCOO, calibrate
from repro_torch.core.perfmodel import runtime_fallback
from repro_torch.core.plancache import PlanCache, key_mentions, nbytes_of
from repro_torch.models import gnn
from repro_torch.serving import (GraphKey, ServingConfig, ServingEngine,
                                 SharedPlanCache, get_shared_cache,
                                 set_shared_cache)
from repro_torch.serving.cache import _PERSIST_FORMAT, _PERSIST_VERSION

RNG = np.random.default_rng(31)
CPU = "cpu"


def _arrays(n, nnz, seed):
    rng = np.random.default_rng(seed)
    flat = np.sort(rng.choice(n * n, size=nnz, replace=False))
    return ((flat // n).astype(np.int32), (flat % n).astype(np.int32),
            np.abs(rng.normal(size=nnz)).astype(np.float32))


def _rand_graph(n=64, nnz=180, seed=5):
    r, c, v = _arrays(n, nnz, seed)
    return SparseCOO((n, n), torch.as_tensor(r), torch.as_tensor(c),
                     torch.as_tensor(v), tag="adjacency")


def _jax_graph(n=64, nnz=180, seed=5):
    r, c, v = _arrays(n, nnz, seed)
    return JCOO((n, n), jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                tag="adjacency")


def _engine(cache, **kw):
    return DynasparseEngine(tile_m=16, tile_n=8, literal=True, cache=cache,
                            device=CPU, **kw)


def _params():
    return gnn.init_params("GCN", 12, 8, 5, device=CPU)


def _dense(adj):
    return adj.todense()


# ------------------------------------------------------------ byte account
def test_nbytes_counts_array_payload():
    assert nbytes_of(np.zeros((4, 4), np.float32)) == 64
    assert nbytes_of(torch.zeros((4, 4), dtype=torch.float32)) == 64
    assert nbytes_of({"a": np.zeros(2, np.float64), "b": [1, 2]}) >= 32
    assert nbytes_of(None) > 0


def test_bytes_used_tracks_puts_and_eviction_by_bytes():
    c = PlanCache(capacity=1000, max_bytes=1000)
    c._put("density", ("a",), np.zeros(100, np.float64))   # 800 B
    assert c.bytes_used == 800
    c._put("density", ("b",), np.zeros(100, np.float64))   # over budget
    assert c.stats.evictions == 1
    assert c.bytes_used == 800                             # 'a' evicted
    assert c._get("density", ("a",)) is None
    assert c._get("density", ("b",)) is not None
    assert c.stats.bytes_evicted == 800


def test_lru_order_spans_entry_kinds():
    c = PlanCache(capacity=1000, max_bytes=2000)
    c._put("density", ("cold",), np.zeros(100, np.float64))
    c._put("plan", ("hot",), np.zeros(100, np.float64))
    c._get("density", ("cold",))
    c._put("struct", ("new",), np.zeros(100, np.float64))  # evicts 'hot'
    assert c._get("plan", ("hot",)) is None
    assert c._get("density", ("cold",)) is not None


def test_engine_respects_byte_budget_across_graphs():
    cache = SharedPlanCache(capacity=10_000, max_bytes=64 * 1024, device=CPU)
    eng = _engine(cache)
    h = RNG.normal(size=(64, 8)).astype(np.float32)
    for seed in range(6):
        adj = _rand_graph(seed=100 + seed)
        z, _ = eng.matmul(adj, h, name=f"g{seed}")
        np.testing.assert_allclose(z.numpy(), _dense(adj) @ h,
                                   rtol=1e-4, atol=1e-4)
    assert cache.bytes_used <= 64 * 1024
    assert cache.stats.evictions > 0


# ------------------------------------------------------------- multi-graph
def test_graph_registry_keys_on_content():
    cache = SharedPlanCache(device=CPU)
    a, b = _rand_graph(seed=1), _rand_graph(seed=2)
    ka = cache.register_graph("a", a)
    kb = cache.register_graph("b", b)
    assert isinstance(ka, GraphKey) and ka != kb
    assert ka.shape == (64, 64) and ka.dtype == "float32"
    assert cache.register_graph("a2", a) == ka
    assert cache.register_graph("a", b) == kb
    assert cache.graphs["a"] == kb
    # the content key is the reference's for the same arrays
    assert ka.fingerprint == JShared().register_graph(
        "a", _jax_graph(seed=1)).fingerprint


def test_two_engines_share_one_packing():
    cache = SharedPlanCache(device=CPU)
    adj = _rand_graph(seed=3)
    h = RNG.normal(size=(64, 8)).astype(np.float32)
    _engine(cache).matmul(adj, h)
    _engine(cache).matmul(adj, h)
    assert cache.stats.packs == 1
    assert cache.stats.analyzes == 1
    assert cache.stats.plan_hits == 1


def test_shared_singleton_roundtrip():
    try:
        set_shared_cache(None)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                get_shared_cache()      # the default cache lives on the card
        mine = SharedPlanCache(device=CPU)
        set_shared_cache(mine)
        assert get_shared_cache() is mine
        assert get_shared_cache() is mine
    finally:
        set_shared_cache(None)


# ------------------------------------------------------------- persistence
def test_save_load_skips_reanalysis(tmp_path):
    adj = _rand_graph(seed=7)
    params = _params()
    h = RNG.normal(size=(64, 12)).astype(np.float32)

    c1 = SharedPlanCache(device=CPU)
    z1, _ = gnn.run_inference("GCN", _engine(c1), adj, h, params, device=CPU)
    path = os.fspath(tmp_path / "plans.pkl")
    manifest = c1.save(path)
    assert manifest["entries"] == len(c1) and manifest["bytes"] > 0

    c2 = SharedPlanCache(device=CPU)
    assert c2.load(path)["entries"] == manifest["entries"]
    z2, _ = gnn.run_inference("GCN", _engine(c2), adj, h, params, device=CPU)
    assert c2.stats.packs == 0 and c2.stats.analyzes == 0
    assert c2.stats.plan_misses == 0
    assert torch.equal(z1, z2)


def test_save_load_restores_compiled_dispatch(tmp_path):
    adj = _rand_graph(seed=9)
    params = _params()
    h = RNG.normal(size=(64, 12)).astype(np.float32)

    c1 = SharedPlanCache(device=CPU)
    z1, _ = gnn.run_inference("GCN", _engine(c1), adj, h, params, device=CPU)
    assert c1.stats.dispatch_builds >= 1
    assert c1.dispatch_count() == c1.stats.dispatch_builds
    path = os.fspath(tmp_path / "dispatch.pkl")
    c1.save(path)

    c2 = SharedPlanCache(device=CPU)
    c2.load(path)
    assert c2.dispatch_count() == c1.dispatch_count()
    for (kind, _k), v in c2.items():
        if kind == SharedPlanCache._DISPATCH:
            assert all(isinstance(a, torch.Tensor) and a.device == c2.device
                       for a in v.arrays.values())
    z2, _ = gnn.run_inference("GCN", _engine(c2), adj, h, params, device=CPU)
    assert c2.stats.dispatch_builds == 0
    assert c2.stats.dispatch_hits >= 1
    assert torch.equal(z1, z2)


def test_load_restores_device_resident_structures(tmp_path):
    adj = _rand_graph(seed=8)
    c1 = SharedPlanCache(device=CPU)
    _engine(c1).matmul(adj, RNG.normal(size=(64, 8)).astype(np.float32))
    path = os.fspath(tmp_path / "p.pkl")
    c1.save(path)
    c2 = SharedPlanCache(device=CPU)
    c2.load(path)
    structs = [v for (kind, _), v in c2.items() if kind == "struct"]
    assert structs, "no structure entries restored"
    for s in structs:
        for bcsr in s.stripes.values():
            assert isinstance(bcsr.blocks, torch.Tensor)
            assert isinstance(bcsr.row_ids, torch.Tensor)
            assert bcsr.blocks.device == c2.device


def test_activation_dispatch_roundtrip_keeps_act_caps(tmp_path):
    """The port's ActivationDispatch carries ``act_caps`` (the budget
    vector on the device), a key the reference lacks: it round-trips with
    the descriptor arrays, and a restarted compiled program replays zero
    activation lowerings."""
    adj = _rand_graph(n=80, nnz=240, seed=12)
    params = gnn.init_params("GIN", 12, 8, 5, device=CPU)
    h = RNG.normal(size=(80, 12)).astype(np.float32)
    h *= RNG.uniform(size=h.shape) < 0.2
    c1 = SharedPlanCache(device=CPU)
    warm, cm = gnn.compile_model("GIN", _engine(c1), adj, torch.as_tensor(h),
                                 params)
    assert cm is not None and cm.n_act >= 1
    before = {key: v for (kind, key), v in c1.items()
              if kind == PlanCache._ACT}
    path = os.fspath(tmp_path / "act.pkl")
    c1.save(path)
    c2 = SharedPlanCache(device=CPU)
    c2.load(path)
    after = {key: v for (kind, key), v in c2.items()
             if kind == PlanCache._ACT}
    assert after.keys() == before.keys() and after
    for key, d in after.items():
        assert "act_caps" in d.arrays
        assert d.arrays.keys() == before[key].arrays.keys()
        for k, a in d.arrays.items():
            assert torch.equal(a, before[key].arrays[k]), k
        assert d.geom == before[key].geom
    e2 = _engine(c2)
    warm2, cm2 = gnn.compile_model("GIN", e2, adj, torch.as_tensor(h), params)
    assert c2.stats.act_builds == 0 and c2.stats.dispatch_builds == 0
    assert c2.stats.packs == 0
    assert torch.equal(warm2, warm)
    assert torch.equal(cm2(torch.as_tensor(h)), cm(torch.as_tensor(h)))


def test_cache_keys_equal_reference_after_the_same_inference():
    """Same graph, same features, same parameters: the port's cache holds
    the reference's (kind, key) entries in the reference's LRU order, and
    the restored snapshot keeps them."""
    params_j = jgnn.init_params("GCN", 12, 8, 5)
    h = RNG.normal(size=(64, 12)).astype(np.float32)
    jc = JShared()
    jgnn.run_inference("GCN", JEngine(tile_m=16, tile_n=8, literal=True,
                                      cache=jc),
                       _jax_graph(seed=4), jnp.asarray(h), params_j)
    tc = SharedPlanCache(device=CPU)
    gnn.run_inference("GCN", _engine(tc), _rand_graph(seed=4), h,
                      gnn.params_from_jax(params_j, CPU), device=CPU)
    assert [k for k, _ in tc.items()] == [k for k, _ in jc.items()]


def test_reregister_purges_superseded_content(tmp_path):
    adjA, adjB = _rand_graph(seed=21), _rand_graph(seed=22)
    params = _params()
    h = RNG.normal(size=(64, 12)).astype(np.float32)

    cache = SharedPlanCache(device=CPU)
    gnn.run_inference("GCN", _engine(cache), adjA, h, params, device=CPU)
    fpA = GraphKey.of(adjA).fingerprint
    cache.register_graph("g", adjA)
    nA = sum(1 for (k, key), _ in cache.items() if key_mentions(key, fpA))
    assert nA > 0 and cache.dispatch_count() >= 1

    cache.register_graph("g2", adjA)
    cache.register_graph("g", adjB)
    assert sum(1 for (k, key), _ in cache.items()
               if key_mentions(key, fpA)) == nA
    cache.register_graph("g2", adjB)
    assert sum(1 for (k, key), _ in cache.items()
               if key_mentions(key, fpA)) == 0
    assert cache.stats.invalidations == nA

    path = os.fspath(tmp_path / "swap.pkl")
    cache.save(path)
    c2 = SharedPlanCache(device=CPU)
    c2.load(path)
    assert not any(key_mentions(key, fpA) for (k, key), _ in c2.items())


def test_load_skips_entries_of_superseded_registration(tmp_path):
    adjA, adjB = _rand_graph(seed=23), _rand_graph(seed=24)
    params = _params()
    h = RNG.normal(size=(64, 12)).astype(np.float32)

    c1 = SharedPlanCache(device=CPU)
    gnn.run_inference("GCN", _engine(c1), adjA, h, params, device=CPU)
    c1.register_graph("g", adjA)
    path = os.fspath(tmp_path / "restart.pkl")
    c1.save(path)
    fpA = GraphKey.of(adjA).fingerprint
    nA = sum(1 for (k, key), _ in c1.items() if key_mentions(key, fpA))

    c2 = SharedPlanCache(device=CPU)
    c2.register_graph("g", adjB)
    manifest = c2.load(path)
    assert manifest["stale_skipped"] == nA
    assert not any(key_mentions(key, fpA) for (k, key), _ in c2.items())
    assert c2.graphs["g"] == GraphKey.of(adjB)
    z, _ = gnn.run_inference("GCN", _engine(c2), adjB, h, params, device=CPU)
    ref = gnn.run_reference("GCN", adjB, torch.as_tensor(h), params)
    np.testing.assert_allclose(z.numpy(), ref.numpy(), rtol=1e-3, atol=1e-3)


def test_load_rejects_unknown_version(tmp_path):
    path = os.fspath(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"format": _PERSIST_FORMAT, "version": 999,
                     "entries": [], "graphs": {}}, f)
    cache = SharedPlanCache(device=CPU)
    manifest = cache.load(path)
    assert manifest["cold_start"] is True
    assert manifest["entries"] == 0
    assert "snapshot version" in manifest["error"]
    assert cache.stats.snapshot_errors == 1
    assert len(cache) == 0


def test_load_skips_sharded_dispatch_from_bigger_mesh(tmp_path):
    """A snapshot carrying an 8-device sharded dispatch must not poison a
    1-device restart: the oversized entry is skipped (and counted in the
    manifest), while a mesh-1 sharded entry loads and is re-uploaded."""
    from repro_torch.core.dispatch import DispatchGeometry
    from repro_torch.core.shard_exec import ShardedDispatch

    geom = DispatchGeometry(M=16, K=16, N=8, tm=8, tn=8, SM=8, SN=8, B=8,
                            nrt=2, nct=1, has_gemm=False, has_spdmm=True,
                            has_spmm=False)
    arrays = {"sp_a": np.zeros((1, 3), np.int32)}

    def shard(nd):
        return ShardedDispatch(
            geom=geom, n_devices=nd, band_starts=tuple(range(nd + 1)),
            band_rows=(16,) * nd, M=16, arrays=dict(arrays),
            fingerprint=f"fp{nd}")

    path = os.fspath(tmp_path / "mesh.pkl")
    entries = [(("sharddispatch", ("k8", "fp8", 8)), shard(8)),
               (("sharddispatch", ("k1", "fp1", 1)), shard(1))]
    with open(path, "wb") as f:
        pickle.dump({"format": _PERSIST_FORMAT, "version": _PERSIST_VERSION,
                     "entries": entries, "graphs": {}}, f)

    cache = SharedPlanCache(device=CPU)
    manifest = cache.load(path)
    assert manifest["mesh_skipped"] == 1
    assert manifest["entries"] == 1
    kept = {key for (kind, key), _ in cache.items()
            if kind == "sharddispatch"}
    assert kept == {("k1", "fp1", 1)}
    # the survivor's descriptor arrays were re-uploaded to the device
    (value,) = [v for (kind, _), v in cache.items()
                if kind == "sharddispatch"]
    assert isinstance(value.arrays["sp_a"], torch.Tensor)
    assert value.arrays["sp_a"].device == torch.device(CPU)


def test_mesh8_snapshot_skipped_and_mesh1_snapshot_replayed(tmp_path):
    """A real CPU snapshot holding the sharded dispatches of an 8-shard and
    a 1-shard engine: on load (the CPU is one device) the 8-shard entry is
    skipped, the 1-shard one restored, and a fresh mesh-1 engine over the
    restored cache lowers nothing and is bitwise equal to a cold one."""
    from repro_torch.launch.mesh import DataMesh

    adj = _rand_graph(n=96, nnz=400, seed=123)
    y = torch.as_tensor(RNG.normal(size=(96, 8)).astype(np.float32))
    cache = SharedPlanCache(device=CPU)
    for nd in (8, 1):
        _engine(cache, mesh=DataMesh((CPU,) * nd)).matmul(adj, y)
    cache.register_graph("g", adj)
    assert cache.sharded_count() == 2
    path = os.fspath(tmp_path / "snap.pkl")
    cache.save(path)

    fresh = SharedPlanCache(device=CPU)
    manifest = fresh.load(path)
    assert manifest["mesh_skipped"] == 1 and manifest["stale_skipped"] == 0
    assert fresh.sharded_count() == 1
    warm = _engine(fresh, mesh=DataMesh((CPU,)))
    z_warm = warm.matmul(adj, y)[0]
    assert fresh.stats.dispatch_builds == 0
    assert fresh.stats.dispatch_hits == 1
    z_cold = _engine(SharedPlanCache(device=CPU),
                     mesh=DataMesh((CPU,))).matmul(adj, y)[0]
    assert torch.equal(z_warm, z_cold)


def test_jax_snapshot_is_a_logged_cold_start(tmp_path):
    """A snapshot written by the JAX package's SharedPlanCache is refused
    by the restricted reader (it names classes of ``repro``): a counted
    cold start that leaves the cache as it was."""
    jc = JShared()
    jgnn.run_inference("GCN", JEngine(tile_m=16, tile_n=8, literal=True,
                                      cache=jc),
                       _jax_graph(seed=6),
                       jnp.asarray(RNG.normal(size=(64, 12)), jnp.float32),
                       jgnn.init_params("GCN", 12, 8, 5))
    path = os.fspath(tmp_path / "jax.pkl")
    jc.save(path)
    cache = SharedPlanCache(device=CPU)
    cache.register_graph("g", _rand_graph(seed=6))
    manifest = cache.load(path)
    assert manifest["cold_start"] is True and manifest["entries"] == 0
    assert "repro." in manifest["error"]
    assert cache.stats.snapshot_errors == 1 and len(cache) == 0
    assert set(cache.graphs) == {"g"}


def _crafted_pickle(module: str, name: str, args: tuple) -> bytes:
    """A protocol-4 pickle that calls ``module``-resolved ``name`` on
    ``args`` (STACK_GLOBAL + REDUCE), as a hostile snapshot would."""
    def text(x):
        b = x.encode()
        return b"\x8c" + bytes([len(b)]) + b
    items = b"".join(text(a) for a in args)
    return (b"\x80\x04" + text(module) + text(name) + b"\x93" + b"]"
            + items + b"e" + b"\x85" + b"R" + b".")


@pytest.mark.parametrize("module,name", [
    ("repro_torch.kernels._build", "subprocess.Popen"),
    ("repro_torch.kernels._build", "ctypes.CDLL"),
    ("subprocess", "Popen"),
    ("repro_torch.serving.engine", "ServingEngine"),
])
def test_crafted_snapshot_runs_nothing_and_cold_starts(tmp_path, module,
                                                       name, monkeypatch):
    """A snapshot that names a class the port's snapshots never hold (a
    dotted name reaching through a port module among them) is refused
    before anything is called: the command it carries never runs, and
    both the plan cache and the calibration level log a cold start."""
    marker = tmp_path / "ran"
    cmd = (sys.executable, "-c", f"open({str(marker)!r}, 'w')")
    path = tmp_path / "crafted.pkl"
    path.write_bytes(_crafted_pickle(module, name, cmd))
    with pytest.raises(pickle.UnpicklingError, match="never holds"):
        with open(path, "rb") as f:
            snapshot.load(f)
    cache = SharedPlanCache(device=CPU)
    manifest = cache.load(os.fspath(path))
    assert manifest["cold_start"] is True and manifest["entries"] == 0
    assert cache.stats.snapshot_errors == 1 and len(cache) == 0
    monkeypatch.setattr(calibrate, "calibrate", lambda *a, **k: "measured")
    calib = PlanCache()
    got = calibrate.get_calibrated(calib, runtime_fallback("cpu"),
                                   snapshot_path=os.fspath(path),
                                   device=CPU)
    assert got == "measured" and calib.stats.snapshot_errors == 1
    assert not marker.exists()


def test_serving_engine_refuses_engine_off_its_cache_device():
    cache = SharedPlanCache(device=CPU)
    eng = _engine(cache)
    cache.device = torch.device("meta")     # a cache for another device
    with pytest.raises(ValueError, match="SharedPlanCache"):
        ServingEngine("GCN", _params(), engine=eng,
                      config=ServingConfig(max_batch=2))


# ----------------------------------------------------------- lazy densify
def test_structure_entry_densifies_only_for_dense_queue():
    adj = _rand_graph(seed=9)
    cache = SharedPlanCache(device=CPU)
    eng = _engine(cache, mode="sparse_only")
    h = RNG.normal(size=(64, 8)).astype(np.float32)
    eng.matmul(adj, h)
    entries = {k: v for k, v in cache.items()}
    structs = [v for (kind, _), v in entries.items() if kind == "struct"]
    assert len(structs) == 1 and structs[0].dense is None

    bytes_before = cache.bytes_used
    eng_d = _engine(cache, mode="dense_only")
    z, _ = eng_d.matmul(adj, h)
    np.testing.assert_allclose(z.numpy(), _dense(adj) @ h,
                               rtol=1e-4, atol=1e-4)
    assert structs[0].dense is not None
    assert cache.bytes_used > bytes_before
