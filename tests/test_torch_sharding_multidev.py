"""The port's LM distribution layer on meshes of repeated CPU devices,
against the JAX reference on 8 forced host devices (one module-scoped
subprocess, as ``tests/test_sharding_multidev.py`` runs it) and against
the port's own single-device paths, on the same numpy inputs:

- sharded training: reduced phi3 (d 64, 2 layers) and reduced
  deepseek-v2-lite (MoE), microbatches 2, batch 8 x 16, one step on
  ``(data 4, model 1)`` and ``(data 4, model 2)``, in bfloat16 and
  float32 compute: each microbatch's 4 rows split over the 4 data ranks
  (the GEMMs of fewer rows and the rank-order sums of the loss and the
  gradients reassociate) and on ``model`` 2 tensor-parallel (the
  row-parallel sums reassociate), so within the reference's gates of the
  port's single-device step (loss 1e-3, parameters 5e-3,
  ``tests/test_sharding_multidev.py:113-117``) and in float32 within the
  float32 gates below; on both within the reference's gates of the
  reference's sharded step, and in float32 the gradient norm and each
  parameter's change within tight tolerances; the same against a second
  reference run (its own subprocess, float32) of reduced qwen2.5-3b
  (GQA), recurrentgemma-9b (RG-LRU), mamba2-780m (SSD) and
  seamless-m4t-medium (enc-dec) on ``(data 4, model 2)``, and of reduced
  qwen2.5-3b with ``seq_shard`` (``tests/test_perf_variants.py``'s
  setup); the ``(1, 1)`` mesh equals ``make_train_step`` bitwise for
  every arch;
- ``pipeline_apply``: within 1e-6 of the reference's and bitwise equal to
  the port's serial loop;
- ``psum8`` on 8 rank inputs: bitwise equal to the reference's
  ``shard_map`` ``psum8``, and within the quantisation budget;
- elastic: a checkpoint saved on ``(data 4, model 2)`` restores onto
  ``(data 2, model 2)`` and onto one device bitwise, each leaf's shards
  following the new spec; a single-device checkpoint restores onto a
  mesh;
- the perf variants of ``tests/test_perf_variants.py:77-89`` on the
  port's ``(data 4, model 2)`` mesh."""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ffn
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import psum8

CPU = torch.device("cpu")
OPT = AdamWConfig(lr=1e-3, warmup_steps=0)   # the reference test's
LOSS_TOL, PARAM_TOL = 1e-3, 5e-3             # its gates
# float32 against the reference: the loss, the gradient norm (relative)
# and one step's parameter change at lr 1e-3 (largest differences read on
# the CPU: 5e-7, 2e-7 and 2.8e-5)
F32_LOSS_TOL, F32_NORM_TOL, F32_CHANGE_TOL = 1e-5, 1e-5, 1e-4
PIPE_TOL = 1e-6

_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.configs import ARCHS
    from repro.configs.reduced import reduce_config
    from repro.models.registry import build_model
    from repro.launch.mesh import make_mesh_for_devices
    from repro.launch.steps import init_state, make_train_step
    from repro.distributed.sharding import params_shardings, batch_shardings
    from repro.distributed.pipeline import pipeline_apply
    from repro.optim.adamw import AdamWConfig
    from repro.optim.compression import psum8
    from jax.sharding import PartitionSpec as P

    out = {}
    mesh = make_mesh_for_devices(8, model_parallel=2)
    runs = [(arch, over, dtype)
            for arch, over in (("phi3-mini-3.8b", dict(d_model=64,
                                                       n_layers=2)),
                               ("deepseek-v2-lite-16b", {}))
            for dtype in ("bfloat16", "float32")]
    for arch, over, dtype in runs:
        cfg = dataclasses.replace(reduce_config(ARCHS[arch]),
                                  microbatches=2, dtype=dtype, **over)
        bundle = build_model(cfg)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
        batch = {"tokens": jnp.asarray(tokens)}
        step = make_train_step(bundle, AdamWConfig(lr=1e-3, warmup_steps=0))
        with mesh:
            state = init_state(bundle)
            init = jax.tree.map(np.asarray, state["params"])
            state = dict(state, params=jax.device_put(
                state["params"], params_shardings(state["params"], mesh)))
            b_sh = batch_shardings(batch, mesh)
            s2, m2 = jax.jit(step, in_shardings=(None, b_sh))(state, batch)
        out[(arch, dtype)] = {
            "tokens": tokens, "init": init, "loss": float(m2["loss"]),
            "grad_norm": float(m2["grad_norm"]),
            "params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   s2["params"])}

    rng = np.random.default_rng(0)
    pmesh = compat.make_mesh((4,), ("pipe",))
    ws = (rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.5)
    xs = rng.normal(size=(6, 3, 16)).astype(np.float32)
    got = pipeline_apply(pmesh, lambda w, x: jnp.tanh(x @ w),
                         jnp.asarray(ws), jnp.asarray(xs))
    out["pipe"] = {"ws": ws, "xs": xs, "out": np.asarray(got)}

    dmesh = compat.make_mesh((8,), ("data",))
    x = rng.normal(size=(8, 32)).astype(np.float32)
    f = compat.shard_map(lambda v: psum8(v, "data"), mesh=dmesh,
                         in_specs=P("data"), out_specs=P(), check=False)
    out["psum8"] = {"x": x, "out": np.asarray(f(jnp.asarray(x)))}
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
    print("RESULT:" + json.dumps({"ok": True}))
""")


# the reference's sharded step (float32) of the archs whose tensor-parallel
# split the first script does not reach: GQA with 2 kv heads, RG-LRU with
# local attention on 1 kv head, SSD, and the encoder-decoder
TP_ARCHS = ("qwen2.5-3b", "recurrentgemma-9b", "mamba2-780m",
            "seamless-m4t-medium")
_TP_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS
    from repro.configs.reduced import reduce_config
    from repro.models.registry import build_model
    from repro.launch.mesh import make_mesh_for_devices
    from repro.launch.steps import init_state, make_train_step
    from repro.distributed.sharding import params_shardings, batch_shardings
    from repro.optim.adamw import AdamWConfig

    out = {}
    mesh = make_mesh_for_devices(8, model_parallel=2)

    def run(cfg, seq):
        bundle = build_model(cfg)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (8, seq)).astype(
            np.int32)}
        if cfg.n_enc_layers:
            batch["frames"] = rng.normal(size=(8, seq, cfg.d_model)).astype(
                np.float32)
        feed = {k: jnp.asarray(v) for k, v in batch.items()}
        step = make_train_step(bundle, AdamWConfig(lr=1e-3, warmup_steps=0))
        with mesh:
            state = init_state(bundle)
            init = jax.tree.map(np.asarray, state["params"])
            state = dict(state, params=jax.device_put(
                state["params"], params_shardings(state["params"], mesh)))
            s2, m2 = jax.jit(step, in_shardings=(
                None, batch_shardings(feed, mesh)))(state, feed)
        return {
            "batch": batch, "init": init, "loss": float(m2["loss"]),
            "grad_norm": float(m2["grad_norm"]),
            "params": jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   s2["params"])}

    for arch in json.loads(sys.argv[2]):
        out[arch] = run(dataclasses.replace(reduce_config(ARCHS[arch]),
                                            microbatches=2, dtype="float32"),
                        16)
    # tests/test_perf_variants.py's seq_shard setup
    out["seq_shard"] = run(dataclasses.replace(
        reduce_config(ARCHS["qwen2.5-3b"]), microbatches=2, remat="full",
        seq_shard=True), 32)
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
    print("RESULT:" + json.dumps({"ok": True}))
""")


def _run_reference(path, script, *args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    proc = subprocess.run([sys.executable, "-c", script, str(path), *args],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as fh:          # written by the script above
        return pickle.load(fh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("ref_multidev") / "ref.pkl",
                          _SCRIPT)


@pytest.fixture(scope="module")
def ref_tp(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("ref_tp") / "ref.pkl",
                          _TP_SCRIPT, json.dumps(TP_ARCHS))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a tensor-parallel step of a reduced arch is
    thousands of small ops, and with the suite's parallel workers each
    spreading every op over all cores, they spent 40x longer waiting for
    each other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(data, model):
    return Mesh.on(CPU, (data, model), ("data", "model"))


def reduced(arch, **over):
    if arch == "phi3-mini-3.8b":
        over = dict(d_model=64, n_layers=2, **over)
    return dataclasses.replace(reduce_config(ARCHS[arch]), microbatches=2,
                               **over)


def ref_leaf(flat_ref, name):
    """The reference leaf of the port's parameter ``name``: its stacked
    array indexed by the layer the port's name carries."""
    path, n = ts.reference_path(name)
    leaf = flat_ref[path]
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit() and parts[i - 1] in ts.PARAM_STACKS:
            leaf = leaf[int(part)]
    return np.asarray(leaf, np.float32)


def flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    return {k: v for key, sub in items
            for k, v in flatten(sub, f"{prefix}{key}/").items()}


def single_and_sharded(cfg, init_tree, tokens, mesh, batch=None):
    """One step of the port from the reference's parameters: single
    device and sharded on ``mesh``; returns ((metrics, {name: tensor}),
    (metrics, state)).  ``batch``: numpy inputs (default ``tokens``)."""
    bundle = build_model(cfg)
    batch = ({k: torch.as_tensor(v) for k, v in batch.items()} if batch
             else {"tokens": torch.as_tensor(tokens).long()})
    model = bundle.params_from_jax(init_tree, device=CPU)
    single = steps.train_state(bundle, model)
    _, m1 = steps.make_train_step(bundle, OPT)(single, batch)
    sharded = steps.sharded_state(
        bundle, bundle.params_from_jax(init_tree, device=CPU), mesh)
    _, m2 = steps.make_train_step(bundle, OPT, mesh=mesh)(sharded, batch)
    return (m1, dict(single["params"].named_parameters())), (m2, sharded)


def assert_within_reference_gates(r, m2, sharded, f32):
    """The port's sharded step (``m2``, ``sharded``) within the
    reference's gates of the reference's sharded step ``r``; in float32
    the gradient norm and each parameter's change within the float32
    gates."""
    assert abs(m2["loss"].item() - r["loss"]) \
        < (F32_LOSS_TOL if f32 else LOSS_TOL)
    if f32:
        assert m2["grad_norm"].item() == pytest.approx(r["grad_norm"],
                                                       rel=F32_NORM_TOL)
    flat_ref, flat_init = flatten(r["params"]), flatten(r["init"])
    for name, leaf in sharded["params"].items():
        got = ts.unshard(leaf, CPU)
        want = ref_leaf(flat_ref, name)
        assert np.abs(got.numpy() - want).max() < PARAM_TOL, name
        if f32:
            init = ref_leaf(flat_init, name)
            assert np.abs((got.numpy() - init) - (want - init)).max() \
                < F32_CHANGE_TOL, name
        assert ts.normalize(leaf.spec) == ts.normalize(
            ts.param_spec(name, leaf.shape, leaf.mesh))


@pytest.mark.parametrize("shape", [(4, 1), (4, 2)], ids=["4x1", "4x2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-lite-16b"])
def test_sharded_training_matches_single_device_and_reference(arch, dtype,
                                                              shape, ref):
    """One step on ``(data 4, model shape[1])`` from the reference's
    parameters.  Bitwise the port's single-device step only where nothing
    reassociates: a ``model`` axis of 1 and microbatch rows the data axes
    do not split (``tests/test_torch_dp_rows.py::
    test_undivided_microbatch_rows_run_whole_bitwise``).  Here each
    microbatch's 4 rows split over the 4 data ranks (their GEMMs run on fewer rows, and the loss and the
    gradients are summed over the ranks in rank order), and with
    ``model`` 2 the step is also tensor-parallel (its row-parallel sums
    reassociate as the reference's do): the loss within 1e-3 and every
    parameter within 5e-3 of the single-device step, and in float32
    within the float32 gates (loss ``F32_LOSS_TOL``, gradient norm rel
    ``F32_NORM_TOL``, each parameter's change ``F32_CHANGE_TOL``).  On
    both, within the reference's gates of its sharded step, and in
    float32 within the float32 gates: the first AdamW step moves an
    element by about the learning rate, which the parameter gate would
    not see."""
    r = ref[(arch, dtype)]
    cfg = reduced(arch, dtype=dtype)
    mesh = mesh_of(*shape)
    (m1, single), (m2, sharded) = single_and_sharded(
        cfg, r["init"], r["tokens"], mesh)
    f32 = dtype == "float32"
    assert len(sharded["params"]) == len(single)
    flat_init = flatten(r["init"])
    owners = steps.MeshCompute(build_model(cfg), mesh).owner_ranks(
        {"tokens": torch.as_tensor(r["tokens"])}, cfg.microbatches)
    assert owners == [(0, 1, 2, 3)] * 2
    assert abs(m2["loss"].item() - m1["loss"].item()) < (
        F32_LOSS_TOL if f32 else LOSS_TOL)
    if f32:
        assert m2["grad_norm"].item() == pytest.approx(
            m1["grad_norm"].item(), rel=F32_NORM_TOL)
    for name, leaf in sharded["params"].items():
        got = ts.unshard(leaf, CPU)
        assert (got - single[name]).abs().max().item() < PARAM_TOL, name
        if f32:
            init = torch.as_tensor(ref_leaf(flat_init, name))
            assert ((got - init) - (single[name] - init)).abs().max() \
                .item() < F32_CHANGE_TOL, name
    assert_within_reference_gates(r, m2, sharded, f32)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tp_step_matches_the_reference(arch, ref_tp):
    """Reduced ``arch`` in float32, microbatches 2, batch 8 x 16, one
    tensor-parallel step on ``(data 4, model 2)`` from the reference's
    parameters: within the reference's gates and the float32 gates of the
    reference's sharded step (on its 8 forced host devices, the same
    mesh)."""
    r = ref_tp[arch]
    _, (m2, sharded) = single_and_sharded(
        reduced(arch, dtype="float32"), r["init"], None, mesh_of(4, 2),
        batch=r["batch"])
    assert_within_reference_gates(r, m2, sharded, True)


def test_seq_shard_step_matches_the_reference(ref_tp):
    """Reduced qwen2.5-3b with ``seq_shard`` (remat full, microbatches 2,
    batch 8 x 32: ``tests/test_perf_variants.py``'s setup) on ``(data 4,
    model 2)``: every microbatch's rows split over the data ranks and its
    sequence over the model ranks, one step from the reference's
    parameters within the reference's gates of its sharded step."""
    r = ref_tp["seq_shard"]
    cfg = reduced("qwen2.5-3b", remat="full", seq_shard=True)
    batch = {k: torch.as_tensor(v) for k, v in r["batch"].items()}
    mesh = mesh_of(4, 2)
    assert steps.MeshCompute(build_model(cfg), mesh).layout(batch, 4) == (
        4, True)
    _, (m2, sharded) = single_and_sharded(cfg, r["init"], None, mesh,
                                          batch=r["batch"])
    assert_within_reference_gates(r, m2, sharded, cfg.dtype == "float32")


def _arch_batch(cfg, rows, seq=8):
    rng = np.random.default_rng(0)
    if cfg.n_enc_layers:
        return {"frames": torch.as_tensor(rng.normal(
                    size=(rows, seq, cfg.d_model)).astype(np.float32)),
                "tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (rows, seq)))}
    if cfg.frontend_prefix > 0:
        lp = int(seq * cfg.frontend_prefix)
        pos = np.broadcast_to(np.arange(seq)[None, :, None], (rows, seq, 3))
        return {"embeds": torch.as_tensor(rng.normal(
                    size=(rows, lp, cfg.d_model)).astype(np.float32)),
                "tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                       (rows, seq - lp))),
                "positions": torch.as_tensor(pos.copy())}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                   (rows, seq)))}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_mesh_1x1_equals_make_train_step_bitwise(arch):
    """Two steps on the ``(1, 1)`` mesh: loss, gradient norm, every
    parameter and both moments equal the single-device step's (float32,
    the arch's microbatches of one row each)."""
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), dtype="float32")
    bundle = build_model(cfg)
    batch = _arch_batch(cfg, rows=max(1, cfg.microbatches))
    single = steps.init_state(bundle, 0, CPU)
    mesh = mesh_of(1, 1)
    sharded = steps.init_state(bundle, 0, CPU, mesh=mesh)
    one = steps.make_train_step(bundle, OPT)
    many = steps.make_train_step(bundle, OPT, mesh=mesh)
    for _ in range(2):
        _, m1 = one(single, batch)
        _, m2 = many(sharded, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m1[k], m2[k]), k
    for name, p in single["params"].named_parameters():
        assert torch.equal(ts.unshard(sharded["params"][name], CPU), p)
        for mom in ("mu", "nu"):
            assert torch.equal(
                ts.unshard(sharded["opt"][mom][name], CPU),
                single["opt"][mom][name])
    assert torch.equal(sharded["opt"]["step"], single["opt"]["step"])


def test_replicated_batch_counts_each_row_once():
    """6 rows on ``(data 4, model 2)``: ``batch_spec``'s guard drops dp
    (the batch is replicated) and each microbatch still counts once: the
    step is bitwise the ``(data 1, model 2)`` step, whose one group runs
    every row, and within the reference's gates of one device's."""
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab, (6, 16)))}
    mesh = mesh_of(4, 2)
    assert ts.batch_spec("tokens", (6, 16), mesh) == (None, None)
    single = steps.init_state(bundle, 0, CPU)
    sharded = steps.init_state(bundle, 0, CPU, mesh=mesh)
    one = steps.init_state(bundle, 0, CPU, mesh=mesh_of(1, 2))
    _, m1 = steps.make_train_step(bundle, OPT)(single, batch)
    _, m2 = steps.make_train_step(bundle, OPT, mesh=mesh)(sharded, batch)
    _, m3 = steps.make_train_step(bundle, OPT, mesh=mesh_of(1, 2))(one,
                                                                   batch)
    assert torch.equal(m3["loss"], m2["loss"])
    assert torch.equal(m3["grad_norm"], m2["grad_norm"])
    assert abs(m1["loss"].item() - m2["loss"].item()) < LOSS_TOL
    for name, p in single["params"].named_parameters():
        got = ts.unshard(sharded["params"][name], CPU)
        assert torch.equal(got, ts.unshard(one["params"][name], CPU))
        assert (got - p).abs().max().item() < PARAM_TOL, name


@pytest.mark.parametrize("shape", [(1, 1), (4, 2)])
def test_replica_uses_whole_blocks_in_place(shape):
    """A compute block that is one stored block on the replica's device is
    the replica's parameter itself (no gathered copy; on the ``(1, 1)``
    mesh every leaf, whole), any other is gathered into a buffer the
    replica keeps.  The replica is model rank 0's local one: on ``(1, 1)``
    the whole model, on ``(4, 2)`` its blocks (heads, columns, vocabulary
    rows), gathered over data where the rules split them there.  After an
    update the next bind sees the new values."""
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (8, 16)))}
    mesh = mesh_of(*shape)
    state = steps.init_state(bundle, 0, CPU, mesh=mesh)
    compute = steps.MeshCompute(bundle, mesh)
    step = steps.make_train_step(bundle, OPT, mesh=mesh)
    split = shape[1] > 1
    splits = compute.plan(0).splits

    def bind():
        return compute.bind_rank(CPU, state["params"], 0)

    def block(n):
        whole = ts.unshard(state["params"][n], CPU)
        sp = splits.get(n)
        if sp is None:
            return whole
        return torch.cat([whole[w] for _, w in sp.regions(whole.shape)],
                         sp.dim)

    step(state, batch)
    kinds = set()
    for n, p in bind().named_parameters():
        leaf = state["params"][n]
        held = tp.held_block(leaf, splits.get(n), (0, 0))
        kinds.add(held)
        assert (p.data_ptr() == leaf.local((0, 0)).data_ptr()) == held, n
        assert ((CPU, 0, n) in compute.gathered) == (not held), n
        assert torch.equal(p, block(n)), n
    assert kinds == ({True} if shape == (1, 1) else {True, False})
    assert split == bool(splits)
    step(state, batch)
    for n, p in bind().named_parameters():
        assert torch.equal(p, block(n)), n


def test_microbatches_route_whole_on_the_first_rank_holding_them():
    """On ``(data 4, model 2)`` (data rank 2 on another device): two
    microbatches of 4 rows each split over the 4 data ranks (the residual
    anchor keeps dp), every rank on its rows; four microbatches of 2
    rows, which 4 ranks do not divide, run whole on the first rank
    holding their rows (rows 2r, 2r+1 on data rank r); a replicated batch
    (6 rows) runs whole on rank 0."""
    devs = np.empty((4, 2), dtype=object)
    for i, j in np.ndindex(4, 2):
        devs[i, j] = torch.device("meta") if i == 2 else CPU
    compute = steps.MeshCompute(build_model(reduced("phi3-mini-3.8b")),
                                Mesh(devs, ("data", "model")))
    meta = torch.device("meta")
    batch = {"tokens": torch.zeros(8, 16, dtype=torch.long)}
    assert compute.owner_ranks(batch, 2) == [(0, 1, 2, 3)] * 2
    assert compute.owners(batch, 2) == [(CPU, CPU, meta, CPU)] * 2
    assert compute.owners(batch, 4) == [(CPU,), (CPU,), (meta,), (CPU,)]
    assert compute.owners({"tokens": torch.zeros(6, 4)}, 2) == [(CPU,),
                                                                (CPU,)]


def test_pipeline_matches_reference_and_serial_loop(ref):
    r = ref["pipe"]
    mesh = Mesh.on(CPU, (4,), ("pipe",))
    ws, xs = torch.as_tensor(r["ws"]), torch.as_tensor(r["xs"])

    def stage_fn(w, x):
        return torch.tanh(x @ w)

    got = pipeline_apply(mesh, stage_fn, ws, xs)
    serial = []
    for m in range(xs.shape[0]):
        y = xs[m]
        for s in range(ws.shape[0]):
            y = stage_fn(ws[s], y)
        serial.append(y)
    assert torch.equal(got, torch.stack(serial))
    assert np.abs(got.numpy() - r["out"]).max() < PIPE_TOL


def test_pipeline_takes_a_tree_of_stage_params():
    mesh = Mesh.on(CPU, (1, 3), ("data", "pipe"))
    rng = np.random.default_rng(3)
    params = {"w": torch.as_tensor(rng.normal(size=(3, 8, 8))
                                   .astype(np.float32)),
              "b": torch.as_tensor(rng.normal(size=(3, 8))
                                   .astype(np.float32))}
    xs = torch.as_tensor(rng.normal(size=(5, 2, 8)).astype(np.float32))
    got = pipeline_apply(mesh, lambda p, x: x @ p["w"] + p["b"], params, xs)
    want = xs
    for s in range(3):
        want = want @ params["w"][s] + params["b"][s]
    assert torch.allclose(got, want, atol=1e-5)


def test_psum8_matches_reference_and_budget(ref):
    r = ref["psum8"]
    x = torch.as_tensor(r["x"])
    got = psum8([x[i] for i in range(8)])
    assert len(got) == 8 and all(g is got[0] or torch.equal(g, got[0])
                                 for g in got)
    assert np.array_equal(got[0].numpy(), r["out"][0]), (
        np.abs(got[0].numpy() - r["out"][0]).max())
    # worst-case quantization budget: n_ranks x 0.5 ulp x shared scale
    budget = 8 * 0.5 * float(np.abs(r["x"]).max()) / 127.0
    assert np.abs(got[0].numpy() - r["x"].sum(0)).max() / budget < 1.0


def test_elastic_reshard_preserves_values():
    """A (data 4, model 2) checkpoint restores onto (data 2, model 2) with
    the new specs, and onto one device, bitwise; a single-device
    checkpoint restores onto a mesh in place."""
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (8, 16)))}
    big = mesh_of(4, 2)
    state = steps.init_state(bundle, 0, CPU, mesh=big)
    steps.make_train_step(bundle, OPT, mesh=big)(state, batch)
    want = {f"{group}.{n}": ts.unshard(leaf, CPU)
            for group, tree in (("params", state["params"]),
                                ("mu", state["opt"]["mu"]),
                                ("nu", state["opt"]["nu"]))
            for n, leaf in tree.items()}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, state, blocking=True)
        small = mesh_of(2, 2)
        with small:
            template = steps.init_state(bundle, 1, CPU, mesh=small)
            step, back = mgr.restore(
                template, shardings=steps.state_shardings(
                    template["params"], small))
        assert step == 3
        assert torch.equal(back["opt"]["step"], state["opt"]["step"])
        for group, tree in (("params", back["params"]),
                            ("mu", back["opt"]["mu"]),
                            ("nu", back["opt"]["nu"])):
            for n, leaf in tree.items():
                assert leaf.mesh is small
                assert leaf.spec == ts.param_spec(n, leaf.shape, small)
                assert torch.equal(ts.unshard(leaf, CPU),
                                   want[f"{group}.{n}"])
                for coord in small.coords():
                    assert tuple(leaf.local(coord).shape) == \
                        ts.block_shape(leaf.spec, leaf.shape, small)
        # the restored state trains on its new mesh
        _, m = steps.make_train_step(bundle, OPT, mesh=small)(back, batch)
        assert math.isfinite(m["loss"].item())

        one = steps.init_state(bundle, 1, CPU)
        mgr.restore(one, step=3)
        for n, p in one["params"].named_parameters():
            assert torch.equal(p, want[f"params.{n}"])
            assert torch.equal(one["opt"]["mu"][n], want[f"mu.{n}"])

        # a single-device checkpoint onto a mesh: in place, by its specs
        mgr.save(4, one, blocking=True)
        on_mesh = steps.init_state(bundle, 2, CPU, mesh=small)
        mgr.restore(on_mesh, step=4)
        for n, p in one["params"].named_parameters():
            assert torch.equal(ts.unshard(on_mesh["params"][n], CPU), p)


def test_restore_with_none_shardings_places_unsharded():
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    mesh = mesh_of(2, 2)
    state = steps.init_state(bundle, 0, CPU, mesh=mesh)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, state, blocking=True)
        _, back = mgr.restore(state, shardings={"params": None,
                                                "opt": None})
        for n, t in back["params"].items():
            assert isinstance(t, torch.Tensor) and t.device == CPU
            assert torch.equal(t, ts.unshard(state["params"][n], CPU))
        with pytest.raises(ValueError, match="no current mesh"):
            mgr.restore(state, shardings=steps.state_shardings(
                state["params"], mesh))
        with pytest.raises(ValueError, match="no entry"):
            with mesh:
                mgr.restore(state, shardings={"params": None})


def test_sharded_save_writes_the_single_device_files():
    cfg = reduced("phi3-mini-3.8b")
    bundle = build_model(cfg)
    with tempfile.TemporaryDirectory() as d:
        one = CheckpointManager(Path(d) / "one")
        one.save(1, steps.init_state(bundle, 0, CPU), blocking=True)
        many = CheckpointManager(Path(d) / "many")
        many.save(1, steps.init_state(bundle, 0, CPU, mesh=mesh_of(4, 2)),
                  blocking=True)
        a = json.loads((Path(d) / "one/step_000000001/manifest.json")
                       .read_text())
        b = json.loads((Path(d) / "many/step_000000001/manifest.json")
                       .read_text())
        assert a["leaves"] == b["leaves"]
        for i in range(len(a["leaves"])):
            f = f"step_000000001/arr_{i}.npy"
            assert np.array_equal(np.load(Path(d) / "one" / f),
                                  np.load(Path(d) / "many" / f))


# ----------------------------- tests/test_perf_variants.py:77-89, the port
def _variant_loss(arch, **over):
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), microbatches=2,
                              remat="full", **over)
    bundle = build_model(cfg)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (8, 32)))}
    mesh = mesh_of(4, 2)
    with mesh:
        state = steps.init_state(bundle, 0, CPU, mesh=mesh)
        _, m = steps.make_train_step(bundle, OPT, mesh=mesh)(state, batch)
    return m["loss"].item()


def test_flash_vjp_skip_loss_matches_baseline():
    assert _variant_loss("phi3-mini-3.8b") == pytest.approx(
        _variant_loss("phi3-mini-3.8b", flash_vjp=True,
                      flash_causal_skip=True), rel=1e-2)


def test_moe_dispatch_shard_loss_matches_baseline():
    # each microbatch's 4 x 32 tokens: capacity 40, which the 4 data ranks
    # of (4, 2) divide, so the flagged step runs the sharded slots
    cfg = dataclasses.replace(reduce_config(ARCHS["deepseek-v2-lite-16b"]),
                              moe_dispatch_shard=True)
    assert ffn.moe_capacity(cfg, 4 * 32) == 40
    assert ffn.slots_split(cfg, 4 * 32, 4)
    assert _variant_loss("deepseek-v2-lite-16b") == pytest.approx(
        _variant_loss("deepseek-v2-lite-16b", moe_dispatch_shard=True),
        rel=1e-2)


def test_seq_shard_compiles_and_is_finite():
    assert math.isfinite(_variant_loss("qwen2.5-3b", seq_shard=True))
