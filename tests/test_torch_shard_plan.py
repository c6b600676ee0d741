"""The port's placement layer and mesh plumbing on the CPU, and its exact
parity with the JAX package: band partitioning, two-level (device, queue)
assignment, per-device reports, mesh validation, plan-key separation and
the mesh-size-1 engine.  Ports every case of ``tests/test_shard_plan.py``
but the two of the language-model meshes (``make_mesh_for_devices``,
``make_production_mesh``); the port's mesh is a
:class:`~repro_torch.launch.mesh.DataMesh` of torch devices."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import analyzer as ja
from repro.core import partition as jpart
from repro.core import scheduler as jsch
from repro.core.perfmodel import VCK5000 as JVCK5000
from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.core import analyzer as _analyzer
from repro_torch.core import scheduler as _scheduler
from repro_torch.core.partition import (DevicePlacement, band_partition,
                                        make_tasks)
from repro_torch.core.perfmodel import VCK5000
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from repro_torch.models import gnn
from repro_torch.serving import SharedPlanCache
from repro_torch.serving.engine import ServingConfig, ServingEngine

CPU = torch.device("cpu")


def _mesh(nd=1):
    return DataMesh((CPU,) * nd)


def _engine(**kw):
    return DynasparseEngine(tile_m=16, tile_n=8, literal=True, device=CPU,
                            **kw)


def _rand_graph(n=96, nnz=500, seed=0):
    r = np.random.default_rng(seed)
    rows = np.sort(r.integers(0, n, nnz)).astype(np.int32)
    cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(nnz).astype(np.float32)
    return SparseCOO((n, n), torch.as_tensor(rows), torch.as_tensor(cols),
                     torch.as_tensor(vals), tag="adjacency")


def _y(seed, n=96, w=8):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, w)).astype(np.float32))


def _cache():
    return SharedPlanCache(device=CPU)


# ------------------------------------------------------------ band_partition
def test_band_partition_balances_uniform_loads():
    loads = np.ones((4, 8))
    assert band_partition(loads, 4) == (0, 2, 4, 6, 8)


def test_band_partition_is_min_makespan():
    """DP result is never worse than any brute-forced contiguous split."""
    rng = np.random.default_rng(1)
    loads = rng.random((3, 7))
    starts = band_partition(loads, 3)
    cost = max(loads[d, starts[d]:starts[d + 1]].sum() for d in range(3))
    best = min(
        max(loads[0, :a].sum(), loads[1, a:b].sum(), loads[2, b:].sum())
        for a in range(8) for b in range(a, 8))
    assert cost <= best + 1e-12


def test_band_partition_heterogeneous_devices_shift_the_split():
    # device 1 is 4x slower: it should get a smaller band
    loads = np.ones((2, 8))
    loads[1] *= 4.0
    starts = band_partition(loads, 2)
    sizes = (starts[1] - starts[0], starts[2] - starts[1])
    assert sizes[0] > sizes[1]


def test_band_partition_more_devices_than_stripes():
    starts = band_partition(np.ones((5, 2)), 5)
    placement = DevicePlacement(5, starts)
    assert placement.n_row_tiles == 2
    assert sum(placement.band_sizes()) == 2


def test_band_partition_rejects_bad_shape():
    with pytest.raises(ValueError, match="n_devices, n_stripes"):
        band_partition(np.ones(4), 2)


@pytest.mark.parametrize("nd,S,seed", [(1, 5, 0), (2, 9, 1), (3, 7, 2),
                                       (4, 13, 3), (8, 6, 4), (8, 40, 5)])
def test_band_partition_equals_reference(nd, S, seed):
    """Same loads, same bands: random loads, ties (integer loads) and
    more devices than stripes."""
    rng = np.random.default_rng(seed)
    for loads in (rng.random((nd, S)),
                  rng.integers(0, 3, (nd, S)).astype(np.float64)):
        assert band_partition(loads, nd) == jpart.band_partition(loads, nd)


# ---------------------------------------------------------- DevicePlacement
def test_device_placement_validation_and_lookup():
    p = DevicePlacement(3, (0, 2, 2, 5))
    assert p.n_row_tiles == 5
    assert p.band_sizes() == (2, 0, 3)
    assert [p.device_of(s) for s in range(5)] == [0, 0, 2, 2, 2]
    assert list(p.stripes_of(1)) == []
    with pytest.raises(ValueError, match="malformed"):
        DevicePlacement(2, (0, 5))
    with pytest.raises(ValueError, match="monotone"):
        DevicePlacement(2, (0, 3, 2))
    with pytest.raises(ValueError, match="outside"):
        p.device_of(5)


def test_device_placement_equals_reference():
    for starts in ((0, 2, 2, 5), (0, 0, 0, 4), (0, 1, 3, 3)):
        p, j = DevicePlacement(3, starts), jpart.DevicePlacement(3, starts)
        assert p.band_sizes() == j.band_sizes()
        assert p.n_row_tiles == j.n_row_tiles
        assert ([p.device_of(s) for s in range(p.n_row_tiles)]
                == [j.device_of(s) for s in range(j.n_row_tiles)])
        assert all(p.stripes_of(d) == j.stripes_of(d) for d in range(3))


# ----------------------------------------------------------- analyze_sharded
def _part(nrt=6, nct=2, tm=8, tn=8, mk=make_tasks):
    rng = np.random.default_rng(3)
    return mk("k", nrt * tm, 64, nct * tn,
              rng.random(nrt), rng.random(nct), tm, tn)


def test_analyze_sharded_covers_every_task_once():
    part = _part()
    stq, dtq, placement = _analyzer.analyze_sharded(
        part, [VCK5000] * 3)
    assert len(stq) + len(dtq) == len(part.tasks)
    for t in stq + dtq:
        assert t.device == placement.device_of(t.i)


def test_analyze_sharded_one_device_matches_analyze_kernel():
    part = _part()
    stq_s, dtq_s, placement = _analyzer.analyze_sharded(part, [VCK5000])
    stq, dtq = _analyzer.analyze_kernel(_part(), VCK5000, "balanced")
    assert placement.band_starts == (0, part.n_row_tiles)
    key = lambda ts: sorted((t.i, t.j, t.queue, t.primitive) for t in ts)
    assert key(stq_s) == key(stq) and key(dtq_s) == key(dtq)


def test_analyze_sharded_rejects_bad_inputs():
    with pytest.raises(ValueError, match="at least one"):
        _analyzer.analyze_sharded(_part(), [])
    with pytest.raises(ValueError, match="unknown mode"):
        _analyzer.analyze_sharded(_part(), [VCK5000], mode="nope")


def _task_key(tasks):
    return [(t.i, t.j, t.queue, t.primitive, t.device, t.t_dense,
             t.t_sparse) for t in tasks]


@pytest.mark.parametrize("nd", [1, 3, 4, 8])
@pytest.mark.parametrize("mode,strategy", [("dynamic", "balanced"),
                                           ("dynamic", "greedy"),
                                           ("sparse_only", "balanced"),
                                           ("dense_only", "balanced")])
def test_analyze_and_simulate_sharded_equal_reference(nd, mode, strategy):
    """Same task grid, same per-device models: the same bands (``==``),
    every task on the same device and queue with the same modelled times,
    and the same per-device simulated reports."""
    slow = dataclasses.replace(VCK5000, name="vck5000-half",
                               f_dense=VCK5000.f_dense / 2,
                               f_sparse=VCK5000.f_sparse / 2)
    jslow = dataclasses.replace(JVCK5000, name="vck5000-half",
                                f_dense=JVCK5000.f_dense / 2,
                                f_sparse=JVCK5000.f_sparse / 2)
    hws = [slow if d % 2 else VCK5000 for d in range(nd)]
    jhws = [jslow if d % 2 else JVCK5000 for d in range(nd)]
    part = _part(nrt=11, nct=3)
    jpt = _part(nrt=11, nct=3, mk=jpart.make_tasks)
    stq, dtq, pl = _analyzer.analyze_sharded(part, hws, strategy=strategy,
                                             mode=mode)
    jstq, jdtq, jpl = ja.analyze_sharded(jpt, jhws, strategy=strategy,
                                         mode=mode)
    assert pl.band_starts == jpl.band_starts
    assert pl.n_devices == jpl.n_devices == nd
    assert _task_key(stq) == _task_key(jstq)
    assert _task_key(dtq) == _task_key(jdtq)
    rep = _scheduler.simulate_sharded(stq, dtq, pl, hws)
    jrep = jsch.simulate_sharded(jstq, jdtq, jpl, jhws)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)


# ---------------------------------------------------------- simulate_sharded
def test_simulate_sharded_per_device_reports():
    part = _part()
    hws = [VCK5000] * 2
    stq, dtq, placement = _analyzer.analyze_sharded(part, hws)
    rep = _scheduler.simulate_sharded(stq, dtq, placement, hws)
    assert len(rep.per_device) == 2
    assert rep.makespan == max(r.makespan for r in rep.per_device)
    assert rep.flops_executed == pytest.approx(
        sum(r.flops_executed for r in rep.per_device))
    with pytest.raises(ValueError, match="hardware models"):
        _scheduler.simulate_sharded(stq, dtq, placement, hws[:1])


def test_schedule_report_merge_pads_per_device():
    a = _scheduler.ScheduleReport.zero()
    hws = [VCK5000] * 2
    stq, dtq, placement = _analyzer.analyze_sharded(_part(), hws)
    rep = _scheduler.simulate_sharded(stq, dtq, placement, hws)
    merged = a.merge(rep)
    assert len(merged.per_device) == 2
    scaled = rep.scaled(0.5)
    assert scaled.per_device[0].makespan == pytest.approx(
        rep.per_device[0].makespan * 0.5)


# ----------------------------------------------------- mesh-1 engine parity
def test_mesh_size_one_engine_matches_plain_engine():
    """A mesh of one device runs the sharded code path end to end and is
    bitwise equal to the plain engine."""
    adj = _rand_graph()
    y = _y(4)
    plain = _engine()
    mesh1 = _engine(mesh=make_data_mesh(1, device="cpu"))
    z_p = plain.matmul(adj, y)[0]
    z_m = mesh1.matmul(adj, y)[0]
    assert torch.equal(z_p, z_m)
    assert mesh1.cache.sharded_count() == 1
    assert mesh1.cache.dispatch_count() == 0
    # the mesh engine reports a per-device breakdown
    rep = mesh1.report
    assert len(rep.by_device) == 1
    assert rep.by_device[0].makespan == pytest.approx(rep.total.makespan)
    assert len(plain.report.by_device) == 1


def test_mesh_engine_plan_keys_are_separate():
    """Mesh and non-mesh engines sharing one cache must not alias plans —
    the mesh plan carries a placement the plain executor doesn't expect."""
    cache = _cache()
    adj = _rand_graph(seed=5)
    y = _y(5)
    plain = _engine(cache=cache)
    mesh1 = _engine(cache=cache, mesh=_mesh(1))
    plain.matmul(adj, y)
    assert plain.last_plan.placement is None
    mesh1.matmul(adj, y)
    assert mesh1.last_plan.placement is not None
    assert cache.plan_count() == 2


def test_mesh_plan_digest_depends_on_geometry():
    """plan_digest must separate placements so a sharded dispatch compiled
    for one banding can never be replayed against another."""
    from repro_torch.core.dispatch import plan_digest

    eng = _engine(mesh=_mesh(1))
    adj = _rand_graph(seed=6)
    eng.matmul(adj, _y(6))
    plan = eng.last_plan
    nrt = plan.part.n_row_tiles
    other = dataclasses.replace(
        plan, placement=DevicePlacement(2, (0, 0, nrt)))
    unplaced = dataclasses.replace(plan, placement=None)
    digests = {plan_digest(p, eng.block) for p in (plan, other, unplaced)}
    assert len(digests) == 3


def test_mesh_engine_rejects_non_data_axes():
    with pytest.raises(ValueError, match="axis"):
        _engine(mesh=DataMesh((CPU,), axis_names=("data", "model")))


def test_mesh_engine_rejects_devices_of_another_type():
    """Every mesh device must be of the engine's device type; a mesh
    engine's device is the mesh's first."""
    with pytest.raises(ValueError, match="device type"):
        _engine(mesh=DataMesh((CPU, torch.device("cuda", 0))))
    assert _engine(mesh=_mesh(4)).device == CPU


# -------------------------------------------------------------- mesh factory
def test_make_data_mesh_validates():
    with pytest.raises(ValueError, match=">= 1"):
        make_data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="DataMesh"):
        make_data_mesh(2, device="cpu")
    mesh = make_data_mesh(1, device="cpu")
    assert mesh.axis_names == ("data",)
    assert mesh.devices == (CPU,) and mesh.size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_data_mesh(1)
    else:
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="visible"):
            make_data_mesh(n + 1)


def test_data_mesh_shards_may_share_a_device():
    mesh = DataMesh(("cpu",) * 4)
    assert mesh.size == 4 and set(mesh.devices) == {CPU}
    with pytest.raises(ValueError, match="at least one"):
        DataMesh(())


# ------------------------------------------------------------------ serving
def test_serving_config_n_devices_one_device():
    params = gnn.init_params("GCN", 12, 8, 5, device=CPU)
    srv = ServingEngine("GCN", params,
                        config=ServingConfig(max_batch=2, n_devices=1),
                        cache=_cache())
    assert srv.engine.n_devices == 1
    assert srv.engine.mesh is not None
    assert srv.engine.literal and srv.engine.batched
    assert srv.dispatch_stats()["n_devices"] == 1
    srv.close()


def test_serving_config_n_devices_conflict():
    params = gnn.init_params("GCN", 12, 8, 5, device=CPU)
    eng = _engine()   # 1 "device", no mesh
    with pytest.raises(ValueError, match="conflicts"):
        ServingEngine("GCN", params, engine=eng,
                      config=ServingConfig(max_batch=2, n_devices=2))


# ------------------------------------------------- operand sharding / halo
def test_operand_sharding_validated_and_cache_keyed():
    """Bad mode rejected up front; halo and replicate engines sharing one
    cache produce bitwise-equal results from two distinct sharded entries
    (the mode is part of the dispatch cache key)."""
    with pytest.raises(ValueError, match="operand_sharding"):
        _engine(mesh=_mesh(1), operand_sharding="bogus")

    cache = _cache()
    adj = _rand_graph(seed=10)
    y = _y(10)
    eh = _engine(cache=cache, mesh=_mesh(1))   # halo is the default
    er = _engine(cache=cache, mesh=_mesh(1), operand_sharding="replicate")
    zh = eh.matmul(adj, y)[0]
    zr = er.matmul(adj, y)[0]
    assert torch.equal(zh, zr)
    assert cache.sharded_count() == 2
    acct = cache.sharded_operand_bytes()
    assert acct["entries"] == 2
    assert acct["owned_bytes"] > 0


def test_per_device_models_requires_mesh_and_matching_length():
    slow = dataclasses.replace(VCK5000, name="vck5000-half",
                               f_dense=VCK5000.f_dense / 2)
    with pytest.raises(ValueError, match="requires a mesh"):
        _engine(per_device_models=[VCK5000])
    with pytest.raises(ValueError, match="one model per mesh device"):
        _engine(mesh=_mesh(1), per_device_models=[VCK5000, slow])


def test_per_device_models_distinct_plan_key():
    """Per-device model names join the plan key: a default and a
    per-device-model engine sharing one cache coexist as two plans (in a
    model-invariant mode the math is identical, so results stay bitwise
    equal — only the cache keys differ)."""
    cache = _cache()
    adj = _rand_graph(seed=11)
    y = _y(11)
    slow = dataclasses.replace(VCK5000, name="vck5000-half",
                               f_dense=VCK5000.f_dense / 2,
                               f_sparse=VCK5000.f_sparse / 2)
    e1 = _engine(cache=cache, mode="sparse_only", strategy="greedy",
                 mesh=_mesh(1))
    e2 = _engine(cache=cache, mode="sparse_only", strategy="greedy",
                 mesh=_mesh(1), per_device_models=[slow])
    z1 = e1.matmul(adj, y)[0]
    z2 = e2.matmul(adj, y)[0]
    assert torch.equal(z1, z2)
    assert cache.plan_count() == 2


def test_serving_reports_operand_sharding_stats():
    params = gnn.init_params("GCN", 12, 8, 5, device=CPU)
    srv = ServingEngine("GCN", params,
                        config=ServingConfig(max_batch=2, n_devices=1),
                        cache=_cache())
    st = srv.dispatch_stats()
    assert st["operand_sharding"] == "halo"
    assert st["sharded_dispatches"] == 0
    assert "operand_bytes" in st
    srv.close()
