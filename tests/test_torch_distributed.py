"""The port's LM distribution rules and host-side plans against the JAX
reference, on the CPU with no devices: ``param_spec`` /
``params_shardings`` (``fsdp=True`` and ``False``), ``cache_spec`` and
``batch_spec`` equal the reference's with ``==`` (one-axis entries
spelled alike, ``sharding.normalize``) for every leaf of all ten
``ARCHS``, at full and reduced shapes, on four meshes; ``plan_remesh``,
``bubble_fraction``, the mesh factories' errors and ``constrain``'s
resolution equal the reference's.

The reference's rules read only ``mesh.axis_names`` and ``mesh.shape``,
so a stand-in mesh object serves them; its ``NamedSharding`` is replaced
by the bare ``PartitionSpec`` so that ``tree_shardings`` returns specs.
The port's models and caches are built on the ``meta`` device (no
memory), the reference's shapes come from ``jax.eval_shape``.  The
reference stacks layers on a leading axis; the port's dotted names map to
its ``/``-paths by ``sharding.reference_path``, checked here to cover
every reference leaf with the same per-layer shape."""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.reduced import reduce_config as ref_reduce
from repro.distributed import elastic as ref_elastic
from repro.distributed import pipeline as ref_pipeline
from repro.distributed import sharding as rs
from repro.models.registry import build_model as ref_build
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import elastic, pipeline
from repro_torch.distributed import sharding as ts
from repro_torch.launch.mesh import (Mesh, current_mesh,
                                     make_mesh_for_devices,
                                     make_production_mesh)
from repro_torch.models import encdec, lm
from repro_torch.models.registry import build_model

CPU = torch.device("cpu")
META = torch.device("meta")
MESHES = [{"data": 8, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"data": 1, "model": 1}]
MESH_IDS = ["d8m2", "d16m16", "p2d16m16", "d1m1"]


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def port_mesh(shape: dict) -> Mesh:
    return Mesh.on(CPU, tuple(shape.values()), tuple(shape))


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's ``tree_shardings`` returning bare specs."""
    monkeypatch.setattr(rs, "NamedSharding", lambda mesh, spec: spec)


def _ref_flat(tree) -> dict:
    return {rs._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _configs(arch, reduced):
    if reduced:
        return reduce_config(ARCHS[arch]), ref_reduce(REF_ARCHS[arch])
    return ARCHS[arch], REF_ARCHS[arch]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, ref_specs):
    for reduced in (False, True):
        cfg, ref_cfg = _configs(arch, reduced)
        ref = ref_build(ref_cfg)
        tree = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0)))
        shapes = {p: tuple(l.shape) for p, l in _ref_flat(tree).items()}
        meta = (encdec.EncDec if cfg.n_enc_layers else lm.LM)(cfg,
                                                              device=META)
        named = dict(meta.named_parameters())
        covered = set()
        for name, p in named.items():
            path, n = ts.reference_path(name)
            assert shapes[path][n:] == tuple(p.shape), name
            covered.add(path)
        assert covered == set(shapes)
        for shape, fsdp in itertools.product(MESHES, (True, False)):
            want = _ref_flat(rs.params_shardings(tree, StandIn(shape),
                                                 fsdp=fsdp))
            got = ts.params_shardings(meta, port_mesh(shape), fsdp=fsdp)
            for name in named:
                path, n = ts.reference_path(name)
                assert ts.normalize(got[name]) == tuple(want[path])[n:], (
                    arch, reduced, shape, fsdp, name)
            if fsdp:
                for name, p in named.items():
                    path, n = ts.reference_path(name)
                    assert ts.normalize(ts.param_spec(
                        name, tuple(p.shape), port_mesh(shape))) == tuple(
                        rs.param_spec(path, shapes[path], StandIn(shape))
                    )[n:]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_specs_equal_the_reference(arch, ref_specs):
    """Every leaf of the decode cache (batch 4, 64 positions; the enc-dec
    arch's cross-attention cache at the reference's 1024 targets)."""
    for reduced in (False, True):
        cfg, ref_cfg = _configs(arch, reduced)
        ref = ref_build(ref_cfg)
        tree = ref.abstract_cache(4, 64)
        shapes = {p: tuple(l.shape) for p, l in _ref_flat(tree).items()}
        cache = build_model(cfg).init_cache(4, 64, device=META)
        leaves = ts._tree_specs(cache, port_mesh(MESHES[0]),
                                lambda n, s, m: s)
        covered = set()
        for name, shape in leaves.items():
            path, n = ts.reference_path(name, ts.CACHE_STACKS)
            assert shapes[path][n:] == shape, name
            covered.add(path)
        assert covered == set(shapes)
        for shape in MESHES:
            want = _ref_flat(rs.cache_shardings(tree, StandIn(shape)))
            got = ts.cache_shardings(cache, port_mesh(shape))
            for name, spec in got.items():
                path, n = ts.reference_path(name, ts.CACHE_STACKS)
                assert ts.normalize(spec) == tuple(want[path])[n:], (
                    arch, reduced, shape, name)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_batch_specs_equal_the_reference(mesh_shape, ref_specs):
    batches = [{"tokens": np.zeros((b, 16), np.int32)}
               for b in (1, 2, 3, 8, 16, 24, 32, 512)]
    batches.append({"frames": np.zeros((32, 16, 64), np.float32),
                    "tokens": np.zeros((32, 16), np.int32),
                    "positions": np.zeros((32, 16, 3), np.int32),
                    "pos": np.zeros((), np.int32)})
    for batch in batches:
        want = _ref_flat(rs.batch_shardings(batch, StandIn(mesh_shape)))
        got = ts.batch_shardings({k: torch.from_numpy(v) for k, v in
                                  batch.items()}, port_mesh(mesh_shape))
        assert {k: ts.normalize(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}


def test_normalize_spells_specs_as_partition_spec():
    from jax.sharding import PartitionSpec as P
    for spec in [(("data",), None), (("pod", "data"), ("model",)),
                 ((), "model"), (None,), ()]:
        assert ts.normalize(spec) == tuple(P(*spec))


def test_constrain_is_the_identity_outside_a_mesh():
    x = torch.randn(4, 6, 8)
    assert current_mesh() is None
    assert ts.constrain(x, "dp", "model", None) is x


@pytest.mark.parametrize("mesh_shape", MESHES + [{"pipe": 4}],
                         ids=MESH_IDS + ["pipe4"])
def test_constrain_resolves_as_the_reference(mesh_shape, monkeypatch):
    """Inside a mesh ``constrain`` returns ``x`` itself, and its entries
    resolve as the reference's ``constrain`` resolves them under the same
    mesh (the reference's constraint captured instead of applied)."""
    stand_in = StandIn(mesh_shape)
    monkeypatch.setattr(rs, "_current_mesh", lambda: stand_in)
    monkeypatch.setattr(rs, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(rs.jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    entries = ["dp", "model", "data", "pod", None, "pipe"]
    mesh = port_mesh(mesh_shape)
    for shape in [(8, 32, 64), (3, 16, 2), (32, 1, 256), (512, 24, 7)]:
        x = torch.zeros(shape)
        for ents in itertools.product(entries, repeat=3):
            want = tuple(rs.constrain(np.zeros(shape), *ents))
            with mesh:
                assert ts.constrain(x, *ents) is x
            assert ts.normalize(ts.resolve(shape, ents, mesh)) == want


def test_plan_remesh_equals_the_reference():
    for n, mp, data, pods in itertools.product(
            [1, 2, 3, 4, 8, 16, 24, 100, 128, 200, 255, 256, 384, 512],
            [1, 2, 4, 8, 16], [1, 2, 4, 8, 16, 32], [1, 2]):
        kw = dict(model_parallel=mp, original_data=data, original_pods=pods)
        try:
            want = ref_elastic.plan_remesh(n, **kw)
        except (ValueError, AssertionError) as e:
            with pytest.raises(type(e)):
                elastic.plan_remesh(n, **kw)
            continue
        assert dataclasses.astuple(elastic.plan_remesh(n, **kw)) == \
            dataclasses.astuple(want)


def test_bubble_fraction_equals_the_reference():
    for s, m in itertools.product(range(1, 17), range(1, 33)):
        assert pipeline.bubble_fraction(s, m) == \
            ref_pipeline.bubble_fraction(s, m)


# ---------------------------------------- tests/test_distributed.py:132-142
def test_elastic_plan_shrinks_data_axis():
    plan = elastic.plan_remesh(200, model_parallel=16, original_data=16)
    assert plan.mesh_shape == (8, 16)
    assert plan.n_devices == 128
    assert plan.microbatch_scale == 2


def test_elastic_plan_rejects_too_few():
    with pytest.raises(ValueError):
        elastic.plan_remesh(8, model_parallel=16)


def test_remesh_builds_the_plan_over_visible_devices():
    plan = elastic.plan_remesh(1, model_parallel=1, original_data=4)
    mesh = elastic.remesh(plan, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert plan.microbatch_scale == 4
    with pytest.raises(ValueError, match="visible"):
        elastic.remesh(elastic.plan_remesh(4, model_parallel=2,
                                           original_data=2), device="cpu")


# ---------------------------- tests/test_shard_plan.py:218-223, 308-319
def test_make_mesh_for_devices_validates():
    with pytest.raises(ValueError, match="positive"):
        make_mesh_for_devices(0)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh_for_devices(3, model_parallel=2)
    for bad in (dict(model_parallel=0), dict(pods=-1)):
        with pytest.raises(ValueError, match="positive"):
            make_mesh_for_devices(4, **bad)
    mesh = make_mesh_for_devices(1, device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    assert make_mesh_for_devices(1, pods=1, device="cpu").devices.shape == \
        (1, 1)


def test_make_mesh_for_devices_errors_match_the_reference():
    from repro.launch.mesh import make_mesh_for_devices as ref_make
    for args in [(0, 1, 1), (4, 0, 1), (4, 1, 0), (3, 2, 1), (6, 2, 2),
                 (-1, 2, 2)]:
        n, mp, pods = args
        with pytest.raises(ValueError) as want:
            ref_make(n, model_parallel=mp, pods=pods)
        with pytest.raises(ValueError) as got:
            make_mesh_for_devices(n, model_parallel=mp, pods=pods,
                                  device="cpu")
        assert str(got.value) == str(want.value)


def test_make_production_mesh_is_deprecated_shim():
    for device in ("cpu", "cuda"):
        if device == "cuda" and torch.cuda.is_available():
            continue
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="needs 256 devices"):
                make_production_mesh(device=device)
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="single host"):
                make_production_mesh(multi_pod=True, device=device)


def test_mesh_holds_devices_in_its_shape():
    devs = np.empty((2, 3), dtype=object)
    for i, j in np.ndindex(2, 3):
        devs[i, j] = "cpu"
    mesh = Mesh(devs, ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert list(mesh.coords())[:2] == [(0, 0), (0, 1)]
    assert mesh.device((1, 2)) == CPU
    with pytest.raises(ValueError, match="axis names"):
        Mesh(devs, ("data",))
    outer, inner = Mesh.on(CPU, (2,), ("pipe",)), port_mesh({"data": 2})
    with outer:
        with inner:
            assert current_mesh() is inner
        assert current_mesh() is outer
    assert current_mesh() is None


# ------------------------------------------------------------ placement
@pytest.mark.parametrize("spec", [(None, None), ("data", None),
                                  (("data",), "model"),
                                  (("pod", "data"), None),
                                  ("model", ("pod", "data"))])
def test_shard_and_unshard_round_trip(spec):
    mesh = port_mesh({"pod": 2, "data": 2, "model": 2})
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    leaf = ts.shard(t, spec, mesh)
    assert torch.equal(ts.unshard(leaf, CPU), t)
    n_blocks = ts._size(mesh, spec[0]) * ts._size(mesh, spec[1])
    assert len({block for block, _ in leaf.tensors}) == n_blocks
    # one tensor per distinct block on one device: replicated coordinates
    # share it
    assert len(leaf.tensors) == n_blocks
    for coord in mesh.coords():
        blk = ts.block_index(spec, mesh, coord)
        assert torch.equal(leaf.local(coord), t[leaf.slices(blk)])
        assert leaf.nbytes(coord) == t.numel() * 4 // n_blocks
    t2 = t * 2
    ts.fill(leaf, t2)
    assert torch.equal(ts.unshard(leaf, CPU), t2)
    assert t.data_ptr() not in {x.data_ptr() for x in leaf.tensors.values()}


def test_shard_refuses_a_spec_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        ts.shard(torch.zeros(3, 4), ("data", None), port_mesh({"data": 2}))
