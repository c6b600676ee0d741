"""The port's sharded compiled dispatch on the CPU, in one process: meshes
of 1, 4 and 8 shards that share the CPU (``DataMesh((cpu,) * nd)``), the
port's counterpart of the reference's forced host devices.  Ports the GNN
half of ``tests/test_sharding_multidev.py`` (the eight pinned cases, the
block-diagonal case, the per-device-model case and the derandomized
hypothesis sweep) and adds parity with the JAX package:

- every array of the port's ``build_sharded_dispatch`` (``gemm_*``,
  ``sp_*``, ``mm_*``, ``hx_*``), its ``HaloGeometry``, column supports and
  fingerprint equal the reference's ``build_sharded_dispatch`` of the same
  plan, with ``==``;
- a mesh-1 engine is within 1e-4 of the reference's ``make_data_mesh(1)``
  engine, and banding-invariant modes at 4 and 8 shards within 1e-4 of the
  reference's unsharded engine.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DynasparseEngine as JEngine
from repro.core import analyzer as ja
from repro.core import dispatch as jd
from repro.core import partition as jpart
from repro.core import plancache as jpc
from repro.core import scheduler as jsch
from repro.core import shard_exec as jshard
from repro.core.perfmodel import VCK5000 as JVCK5000
from repro.core.primitives import SparseCOO as JCOO
from repro.launch.mesh import make_data_mesh as j_make_data_mesh
from repro_torch.core import DynasparseEngine, SparseCOO
from repro_torch.core import halo as _halo
from repro_torch.core import scheduler as _scheduler
from repro_torch.core.perfmodel import VCK5000
from repro_torch.device import host
from repro_torch.launch.mesh import DataMesh

CPU = torch.device("cpu")
MESHES = {nd: DataMesh((CPU,) * nd) for nd in (1, 4, 8)}
TOL = dict(rtol=1e-4, atol=1e-4)

# (n, tile_m, tile_n, width, nnz, mode, strategy, eps, y zero share, seed):
# ragged tails, 7 stripes over 4/8 shards, dense-ish mixed-queue graphs,
# eps-thresholded SpMM (sparse Y), forced queues
PINNED = [
    (100, 16, 8, 12, 400, "dynamic", "balanced", 0.0, 0.0, 1),
    (100, 16, 8, 12, 400, "dynamic", "greedy", 0.0, 0.0, 2),
    (64, 8, 8, 4, 2000, "dynamic", "balanced", 0.0, 0.0, 3),
    (64, 8, 8, 4, 2000, "dynamic", "greedy", 0.5, 0.8, 4),
    (40, 8, 16, 20, 60, "sparse_only", "balanced", 0.0, 0.8, 5),
    (129, 16, 8, 8, 800, "dense_only", "balanced", 0.0, 0.0, 6),
    (17, 8, 8, 8, 40, "dynamic", "balanced", 0.5, 0.5, 7),
    (56, 8, 8, 8, 900, "sparse_only", "balanced", 0.5, 0.8, 8),
]
IDS = [f"seed{c[-1]}-{c[5]}-{c[6]}" for c in PINNED]


def _arrays(n, nnz, seed):
    r = np.random.default_rng(seed)
    rows = np.sort(r.integers(0, n, nnz)).astype(np.int32)
    cols = r.integers(0, n, nnz).astype(np.int32)
    vals = r.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


def _diag_arrays(n, tm, seed):
    """A block-diagonal adjacency: every edge stays in its row block."""
    r = np.random.default_rng(seed)
    m = n * 6
    rows = np.sort(r.integers(0, n, m)).astype(np.int32)
    offs = r.integers(0, tm, m).astype(np.int32)
    cols = np.minimum((rows // tm) * tm + offs, n - 1).astype(np.int32)
    vals = r.standard_normal(m).astype(np.float32)
    return rows, cols, vals


def _coo(n, arrays):
    return SparseCOO((n, n), *(torch.as_tensor(a) for a in arrays),
                     tag="adjacency")


def _jcoo(n, arrays):
    return JCOO((n, n), *(jnp.asarray(a) for a in arrays), tag="adjacency")


def _dense_y(n, w, seed, zero_frac):
    r = np.random.default_rng(seed + 1)
    y = r.standard_normal((n, w)).astype(np.float32)
    if zero_frac:
        y = np.where(r.random((n, w)) < zero_frac, 0.0, y)
    return y.astype(np.float32)


def _engine(tm, tn, mode, strategy, eps, **kw):
    return DynasparseEngine(tile_m=tm, tile_n=tn, literal=True, mode=mode,
                            strategy=strategy, eps=eps, device=CPU, **kw)


def _eager(eng, plan, adj, y, eps):
    """The single-device EAGER executor on the same placed plan."""
    key, entry = eng._packed_structure(plan, adj)
    xd = eng._ensure_dense(key, entry, adj) if plan.dtq else None
    return _scheduler.execute_plan(plan.part, plan.stq, plan.dtq, xd, y,
                                   block=eng.block, batched=True,
                                   packed=entry.stripes, eps=eps)


def _check(out, n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed,
           arrays=None, oracle=False, diag=False):
    arrays = arrays if arrays is not None else _arrays(n, nnz, seed)
    adj = _coo(n, arrays)
    y = torch.as_tensor(_dense_y(n, w, seed, y_zero))
    z_ref = _engine(tm, tn, mode, strategy, eps).matmul(adj, y)[0]
    # per-band analysis may re-decide STQ/DTQ relative to the global one
    # (each device has its own engines): only banding-INVARIANT configs
    # promise end-to-end bitwise equality at every mesh size; mesh size 1
    # and the executor itself always do
    invariant = mode != "dynamic" or strategy == "greedy"
    for nd in (1, 4, 8):
        eng = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[nd])
        z = eng.matmul(adj, y)[0]
        plan = eng.last_plan
        assert eng.cache.sharded_count() <= 1
        if plan.part.n_row_tiles % nd:
            out["saw_nondivisible"] += 1
        if n % tm:
            out["saw_ragged"] += 1
        if {t.queue for t in plan.stq + plan.dtq} == {"STQ", "DTQ"}:
            out["saw_mixed"] += 1
        if any(t.primitive == "SpMM" for t in plan.stq):
            out["saw_spmm"] += 1
        if not plan.dtq:
            out["saw_sparse_only_x_none"] += 1
        sd = eng.sharded_dispatch_for(plan, adj)
        if sd is not None and sd.halo is not None:
            if sd.halo.max_take > 0:
                out["saw_halo_exchange"] += 1
            elif nd > 1:
                out["saw_empty_halo"] += 1
            if diag and nd > 1:
                out["diag_exchanged_blocks"] += int(sd.halo.max_take)
        if oracle:
            z_r = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[nd],
                          operand_sharding="replicate").matmul(adj, y)[0]
            if not torch.equal(z, z_r):
                out["halo_mismatch"] += 1
        if not torch.equal(z, _eager(eng, plan, adj, y, eps)):
            out["exec_mismatch"] += 1
        if nd == 1 and not torch.equal(z, z_ref):
            out["mesh1_mismatch"] += 1
        if invariant and not torch.equal(z, z_ref):
            out["invariant_mismatch"] += 1
    out["cases"] += 1
    if diag:
        out["diag_cases"] += 1


@pytest.fixture(scope="module")
def sweep():
    out = {"cases": 0, "exec_mismatch": 0, "mesh1_mismatch": 0,
           "invariant_mismatch": 0, "saw_mixed": 0, "saw_spmm": 0,
           "saw_nondivisible": 0, "saw_ragged": 0,
           "halo_mismatch": 0, "saw_halo_exchange": 0, "saw_empty_halo": 0,
           "saw_sparse_only_x_none": 0, "diag_exchanged_blocks": 0,
           "diag_cases": 0}
    for case in PINNED:
        _check(out, *case, oracle=True)
    # block-diagonal anchor, forced onto the STQ: no dense X at all, and
    # no band reads a neighbour's rows
    _check(out, 64, 8, 8, 8, 0, "sparse_only", "greedy", 0.0, 0.0, 42,
           arrays=_diag_arrays(64, 8, 42), oracle=True, diag=True)

    # per-device cost models: a 2x slower device must get a SMALLER band
    # than under the homogeneous default, results bitwise equal
    slow = dataclasses.replace(VCK5000, name="vck5000-half",
                               f_dense=VCK5000.f_dense / 2,
                               f_sparse=VCK5000.f_sparse / 2,
                               mem_bw=VCK5000.mem_bw / 2)
    adj_h = _coo(256, _arrays(256, 4000, 77))
    y_h = torch.as_tensor(_dense_y(256, 16, 77, 0.0))
    homog = _engine(8, 8, "sparse_only", "greedy", 0.0, mesh=MESHES[4])
    hetero = _engine(8, 8, "sparse_only", "greedy", 0.0, mesh=MESHES[4],
                     per_device_models=[VCK5000, slow, VCK5000, VCK5000])
    z_homog = homog.matmul(adj_h, y_h)[0]
    z_hetero = hetero.matmul(adj_h, y_h)[0]
    out["homog_bands"] = list(homog.last_plan.placement.band_sizes())
    out["hetero_bands"] = list(hetero.last_plan.placement.band_sizes())
    out["hetero_bitwise"] = int(torch.equal(z_homog, z_hetero))

    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    @settings(max_examples=10, deadline=None, database=None,
              derandomize=True, suppress_health_check=list(HealthCheck))
    @given(n=st.integers(17, 120), tm=st.sampled_from([8, 16, 32]),
           tn=st.sampled_from([8, 16]), w=st.integers(4, 24),
           deg=st.integers(1, 12),
           mode=st.sampled_from(["dynamic", "sparse_only", "dense_only"]),
           strategy=st.sampled_from(["balanced", "greedy"]),
           eps=st.sampled_from([0.0, 0.5]),
           y_zero=st.sampled_from([0.0, 0.8]),
           seed=st.integers(0, 10_000))
    def prop(n, tm, tn, w, deg, mode, strategy, eps, y_zero, seed):
        _check(out, n, tm, tn, w, max(1, n * deg), mode, strategy, eps,
               y_zero, seed)
    prop()
    return out


def test_sharded_executor_bit_identity(sweep):
    """Sharded compiled execute == single-device eager execute of the SAME
    placed plan, bitwise, on meshes of 1/4/8 shards."""
    assert sweep["cases"] >= 8 + 1 + 10
    assert sweep["exec_mismatch"] == 0


def test_mesh_size_one_is_degenerate_case(sweep):
    """Mesh size 1 goes through the SAME sharded code path and lands
    bitwise equal to the single-device engine, end to end."""
    assert sweep["mesh1_mismatch"] == 0


def test_banding_invariant_modes_bitwise_across_meshes(sweep):
    """Forced-queue modes and the greedy per-task rule are banding
    invariant → end-to-end bitwise equality at every mesh size."""
    assert sweep["invariant_mismatch"] == 0


def test_property_sweep_coverage(sweep):
    """The sweep exercised the corners the sharded lowering must get
    right."""
    assert sweep["saw_mixed"] > 0          # mixed STQ/DTQ assignments
    assert sweep["saw_spmm"] > 0           # eps-thresholded / sparse-Y SpMM
    assert sweep["saw_nondivisible"] > 0   # stripes not divisible by shards
    assert sweep["saw_ragged"] > 0         # ragged last stripe
    assert sweep["saw_sparse_only_x_none"] > 0  # no dense X operand at all


def test_halo_matches_replicated_oracle(sweep):
    """Owned+halo operand distribution is bitwise equal to the replicated
    oracle on the same placed plan, meshes 1/4/8 — and the sweep really
    exchanged halo blocks."""
    assert sweep["halo_mismatch"] == 0
    assert sweep["saw_halo_exchange"] > 0


def test_block_diagonal_graph_exchanges_nothing(sweep):
    """A block-diagonal adjacency has no cross-band edges: the static
    exchange schedule is empty (``max_take == 0``, zero rounds) at every
    mesh size > 1, and results still match the oracle bitwise."""
    assert sweep["diag_cases"] >= 1
    assert sweep["diag_exchanged_blocks"] == 0
    assert sweep["saw_empty_halo"] > 0


def test_heterogeneous_models_shift_band_split(sweep):
    """``per_device_models`` feeds the band DP different cost models: a 2x
    slower device gets a strictly smaller band than under the homogeneous
    default, with bitwise equal results."""
    homog, hetero = sweep["homog_bands"], sweep["hetero_bands"]
    assert sum(hetero) == sum(homog)   # all stripes still placed
    assert hetero[1] < homog[1]        # the slow device (index 1) shrank
    assert sweep["hetero_bitwise"] == 1


# ------------------------------------------------- the dump slot stays dead
@pytest.mark.parametrize("case", PINNED, ids=IDS)
def test_no_real_output_reads_the_dump_slot(case, monkeypatch):
    """Several pad writes land in slot ``L`` of each shard's buffer and
    which wins is unspecified: with slot ``L`` overwritten by NaN after
    the exchange, every halo result is still bitwise equal to the
    replicated one (a pad GEMM reading it writes only the ghost tile)."""
    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = case
    adj = _coo(n, _arrays(n, nnz, seed))
    y = torch.as_tensor(_dense_y(n, w, seed, y_zero))
    exchange = _halo.exchange

    def poisoned(shards, y_own, hg, devices):
        bufs = exchange(shards, y_own, hg, devices)
        for b in bufs:
            b[hg.L] = float("nan")
        return bufs
    monkeypatch.setattr(_halo, "exchange", poisoned)
    for nd in (1, 4, 8):
        z_h = _engine(tm, tn, mode, strategy, eps,
                      mesh=MESHES[nd]).matmul(adj, y)[0]
        z_r = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[nd],
                      operand_sharding="replicate").matmul(adj, y)[0]
        assert torch.equal(z_h, z_r), nd
        assert bool(torch.isfinite(z_h).all())


# ------------------------------------------------------- parity with JAX
def _reference_plan(plan, adj_j, y_j, tm, tn, mode, strategy, eps, nd):
    """The reference's own analysis of the port plan's kernel (its
    densities, the same shard count), checked equal to the port plan, and
    the reference's packed stripes of the same adjacency."""
    p = plan.part
    jp = jpart.make_tasks(p.name, p.M, p.K, p.N, plan.row_density,
                          plan.col_density, p.tile_m, p.tile_n)
    hws = [JVCK5000] * nd
    jstq, jdtq, jpl = ja.analyze_sharded(jp, hws, strategy=strategy,
                                         mode=mode)
    key = lambda ts: [(t.i, t.j, t.queue, t.primitive, t.device) for t in ts]
    assert key(jstq) == key(plan.stq) and key(jdtq) == key(plan.dtq)
    assert jpl.band_starts == plan.placement.band_starts
    je = JEngine(tile_m=tm, tile_n=tn, literal=True, mode=mode,
                 strategy=strategy, eps=eps)
    jplan0 = je.plan(adj_j, y_j)
    _, entry = je._packed_structure(jplan0, adj_j)
    jplan = jpc.KernelPlan(part=jp, stq=jstq, dtq=jdtq,
                           report=jsch.simulate_sharded(jstq, jdtq, jpl, hws),
                           row_density=plan.row_density,
                           col_density=plan.col_density,
                           struct_key=jplan0.struct_key, placement=jpl)
    return jplan, entry.stripes


@pytest.mark.parametrize("operand_sharding", ["halo", "replicate"])
@pytest.mark.parametrize("case", PINNED, ids=IDS)
def test_sharded_dispatch_arrays_equal_reference(case, operand_sharding):
    """For 1, 4 and 8 shards the port's lowering of a placed plan equals
    the reference's lowering of the same plan: every array (``==``, same
    dtype and shape), the halo geometry, the column supports, the operand
    byte account, the band rows and the plan digest."""
    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = case
    arrays = _arrays(n, nnz, seed)
    adj, adj_j = _coo(n, arrays), _jcoo(n, arrays)
    y_np = _dense_y(n, w, seed, y_zero)
    for nd in (1, 4, 8):
        eng = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[nd],
                      operand_sharding=operand_sharding)
        eng.matmul(adj, torch.as_tensor(y_np))
        plan = eng.last_plan
        sd = eng.sharded_dispatch_for(plan, adj)
        jplan, jstripes = _reference_plan(plan, adj_j, jnp.asarray(y_np),
                                          tm, tn, mode, strategy, eps, nd)
        digest = jd.plan_digest(jplan, eng.block)
        jsd = jshard.build_sharded_dispatch(
            jplan.part, jplan.stq, jplan.dtq, jstripes, jplan.placement,
            block=eng.block, eps=eps, fingerprint=digest,
            operand_sharding=operand_sharding)
        assert sd.fingerprint == digest
        assert set(sd.arrays) == set(jsd.arrays)
        for k, v in sd.arrays.items():
            got, want = host(v), np.asarray(jsd.arrays[k])
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert np.array_equal(got, want), (nd, k)
        assert dataclasses.asdict(sd.geom) == dataclasses.asdict(jsd.geom)
        assert (sd.n_devices, sd.band_starts, sd.band_rows, sd.M) == (
            jsd.n_devices, jsd.band_starts, jsd.band_rows, jsd.M)
        assert ([dataclasses.asdict(s) for s in sd.supports]
                == [dataclasses.asdict(s) for s in jsd.supports])
        assert (None if sd.halo is None else dataclasses.asdict(sd.halo)) \
            == (None if jsd.halo is None else dataclasses.asdict(jsd.halo))
        assert sd.operand_bytes == jsd.operand_bytes
        assert sd.operand_sharding == jsd.operand_sharding


@pytest.mark.parametrize("case", PINNED, ids=IDS)
def test_mesh_one_engine_within_tolerance_of_reference(case):
    """The port's mesh-1 engine against the reference's
    ``make_data_mesh(1)`` engine on the same inputs, and (banding-invariant
    modes) the port's 4- and 8-shard engines against the reference's
    unsharded engine."""
    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = case
    arrays = _arrays(n, nnz, seed)
    adj, adj_j = _coo(n, arrays), _jcoo(n, arrays)
    y_np = _dense_y(n, w, seed, y_zero)
    kw = dict(tile_m=tm, tile_n=tn, literal=True, mode=mode,
              strategy=strategy, eps=eps)
    want1 = np.asarray(JEngine(mesh=j_make_data_mesh(1), **kw).matmul(
        adj_j, y_np)[0])
    got1 = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[1]).matmul(
        adj, torch.as_tensor(y_np))[0]
    np.testing.assert_allclose(host(got1), want1, **TOL)
    if mode != "dynamic" or strategy == "greedy":
        want = np.asarray(JEngine(**kw).matmul(adj_j, y_np)[0])
        for nd in (4, 8):
            got = _engine(tm, tn, mode, strategy, eps,
                          mesh=MESHES[nd]).matmul(
                adj, torch.as_tensor(y_np))[0]
            np.testing.assert_allclose(host(got), want, **TOL)


def test_shard_slices_are_views_on_a_shared_device():
    """Shard ``d``'s arrays are slices of the stacked arrays: uploaded once
    (views where the shard's device holds the stacked arrays), memoized per
    device tuple, and refused for a mesh of another size."""
    n, tm, tn, w, nnz, mode, strategy, eps, y_zero, seed = PINNED[0]
    adj = _coo(n, _arrays(n, nnz, seed))
    eng = _engine(tm, tn, mode, strategy, eps, mesh=MESHES[4])
    eng.matmul(adj, torch.as_tensor(_dense_y(n, w, seed, y_zero)))
    sd = eng.sharded_dispatch_for(eng.last_plan, adj)
    shards = sd.shards(MESHES[4].devices)
    assert shards is sd.shards(MESHES[4].devices)
    for d, local in enumerate(shards):
        for k, v in local.items():
            assert torch.equal(v, sd.arrays[k][d])
            assert v.data_ptr() == sd.arrays[k][d].data_ptr()
    with pytest.raises(ValueError, match="mesh of 8"):
        sd.shards(MESHES[8].devices)


def test_shard_lowering_declines_misaligned_geometry():
    """A canvas-misaligned tile geometry has no sharded dispatch: the mesh
    engine takes the eager path, which is placement-agnostic."""
    adj = _coo(60, _arrays(60, 300, 3))
    y = torch.as_tensor(_dense_y(60, 8, 3, 0.0))
    eng = DynasparseEngine(tile_m=12, tile_n=8, literal=True, device=CPU,
                           mesh=MESHES[4])
    z = eng.matmul(adj, y)[0]
    assert eng.cache.sharded_count() == 0
    assert eng.sharded_dispatch_for(eng.last_plan, adj) is None
    ref = DynasparseEngine(tile_m=12, tile_n=8, literal=True, device=CPU)
    np.testing.assert_allclose(host(z), host(ref.matmul(adj, y)[0]), **TOL)


# ------------------------------------------------- models on a mesh engine
@pytest.mark.parametrize("model,dataset", [("GCN", "CO"), ("GIN", "CO"),
                                           ("GraphSAGE", "CI")])
def test_models_on_a_mesh_match_the_single_device_engine(model, dataset):
    """Whole models through 4-shard halo and replicate engines: equal to
    each other bitwise, within 1e-4 of the single-device literal engine,
    and the compiled model (its body run uncaptured here) replays the
    eager mesh run bitwise with every adjacency kernel as a "shard"
    record."""
    from repro_torch.data.graphs import load_graph
    from repro_torch.models import gnn

    g = load_graph(dataset, scale=0.05, device=CPU)
    h = g.features_dense
    params = gnn.init_params(model, h.shape[1], g.stats.hidden,
                             g.stats.classes, device=CPU)
    want, _ = gnn.run_inference(model, DynasparseEngine(literal=True,
                                                        device=CPU),
                                g.adj, h, params, device=CPU)
    outs = {}
    for osh in ("halo", "replicate"):
        eng = DynasparseEngine(literal=True, device=CPU, mesh=MESHES[4],
                               operand_sharding=osh)
        outs[osh], rep = gnn.run_inference(model, eng, g.adj, h, params,
                                           device=CPU)
        assert len(rep.by_device) == 4
        assert eng.cache.sharded_count() >= 1
    assert torch.equal(outs["halo"], outs["replicate"])
    np.testing.assert_allclose(host(outs["halo"]), host(want), **TOL)

    eng = DynasparseEngine(literal=True, device=CPU, mesh=MESHES[4])
    warm, cm = gnn.compile_model(model, eng, g.adj, h, params)
    assert cm is not None and cm.mesh_devices == MESHES[4].devices
    n_adj = sum(m["x_is_adj"] for m in cm.report.meta)
    assert cm.n_sparse == n_adj >= 1
    assert torch.equal(warm, outs["halo"])
    assert torch.equal(cm(h), warm) and torch.equal(cm(h), warm)
    assert cm.traces == 1


def test_capture_refuses_a_mesh_over_several_cards():
    """A CUDA graph belongs to one device: capturing a compiled model whose
    shards sit on distinct cards raises before touching any card; shards
    that share one card are captured like a single-device model."""
    from repro_torch.models.gnn import CompiledModel, EngineReport

    cm = CompiledModel(model="GCN", run=None, payload=[],
                       report=EngineReport(), input_sketch=np.zeros(1),
                       sketch_tile=8, n_kernels=0, n_sparse=0,
                       device=torch.device("cuda", 0),
                       mesh_devices=(torch.device("cuda", 0),
                                     torch.device("cuda", 1)))
    with pytest.raises(NotImplementedError, match="one device"):
        cm._capture(torch.zeros(2, 2))
