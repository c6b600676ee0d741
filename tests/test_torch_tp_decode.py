"""The port's decode step on a ``model`` axis (``make_serve_step(bundle,
mesh)``, ``distributed/tensor_parallel.py``'s decode) on meshes of
repeated CPU devices, against the port's own whole layers and
single-device decode and against the JAX reference's sharded serve step,
on the same numpy inputs:

- each layer family's decode on ``(1, 2)`` and ``(1, 4)``, several steps
  so that the written slot crosses the ranks' slices of the cache length
  (GQA with fewer kv heads than ranks, the local-window ring, MLA, RG-LRU,
  SSD with its conv window crossing the ranks' channels, MoE, the enc-dec
  cross-attention): the output and every cache block against the whole
  layer's decode, in float32 within ``LAYER_TOL``;
- the split-KV softmax: a slice with no visible position adds nothing, and
  a group of one rank is ``Attention.decode`` bitwise;
- every reduced arch's decode loop on ``(2, 2)`` against the single-device
  decode, teacher-forced (float32 within 1e-5, bfloat16 within 5e-2), the
  placed cache's blocks against the single-device cache's regions, and
  the ``(1, 1)`` mesh bitwise;
- MoE routing over the data-parallel ranks: the dropped choices equal one
  device's; ``CapturedDecode`` of the mesh step (its uncaptured body here)
  equals the eager step;
- the reference's ``make_serve_step`` jitted with ``(params_shardings,
  cache_shardings, batch_shardings)`` on ``(data 4, model 2)`` of 8 forced
  host devices (one module-scoped subprocess), float32, five reduced
  archs: logits within 1e-4 at every step."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.distributed import sharding as ts
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import encdec, ffn, layers, lm, mixers
from repro_torch.models.registry import build_model

CPU = torch.device("cpu")
# a split layer against the whole one in float32: the split-KV combine and
# the row-parallel sums reassociate
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL, BF16_TOL, REF_TOL = 1e-5, 5e-2, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a tensor-parallel decode of a reduced arch is
    thousands of small ops, and with the suite's parallel workers each
    spreading every op over all cores, they spend longer waiting for each
    other than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(arch, dtype="float32"):
    return dataclasses.replace(reduce_config(ARCHS[arch]), dtype=dtype)


def mesh_of(data, model):
    return Mesh.on(CPU, (data, model), ("data", "model"))


def placed(model, mesh):
    specs = ts.params_shardings(model, mesh)
    return {n: ts.shard(p, specs[n], mesh)
            for n, p in model.named_parameters()}


def random_cross(cache, seed=3):
    """The enc-dec cache's cross k / v filled from a seeded generator (the
    serve loop leaves them zero, which attends to nothing)."""
    gen = torch.Generator().manual_seed(seed)
    for c in cache.get("dec", []):
        for name in ("cross_k", "cross_v"):
            c[name].copy_(torch.randn(c[name].shape, generator=gen))
    return cache


def cache_close(single, cache, what, tol):
    """Every stored block of the placed ``cache`` against its region of the
    single-device cache."""
    want = ts.tree_leaves(single)
    for path, leaf in ts.tree_leaves(cache).items():
        for (block, _), t in leaf.tensors.items():
            ref = want[path][leaf.slices(block)]
            assert torch.allclose(t.float(), ref.float(), rtol=tol,
                                  atol=tol), (what, path, block)


# ------------------------------------------------------------ layer families
# (arch, steps, cache length): qwen2.5-3b's 2 kv heads on 4 ranks; the
# recurrentgemma ring (window 16) wraps after 16 steps; MLA + MoE; SSD;
# the enc-dec decoder layer (self- and cross-attention)
FAMILIES = [("qwen2.5-3b", 6, 8), ("recurrentgemma-9b", 20, 24),
            ("deepseek-v2-lite-16b", 6, 8), ("mamba2-780m", 6, 8),
            ("seamless-m4t-medium", 5, 8)]


def decoder_layers(model):
    return (list(model.dec_layers) if isinstance(model, encdec.EncDec)
            else model.layers())


def layer_cache_list(cfg, cache):
    return cache["dec"] if cfg.n_enc_layers else lm.layer_caches(cfg, cache)


@pytest.mark.parametrize("T", [2, 4])
@pytest.mark.parametrize("arch,n_steps,max_len", FAMILIES)
def test_layer_decode_matches_the_whole_layer(arch, n_steps, max_len, T):
    """Every decoder layer of reduced ``arch`` on a group of T ranks, fed
    the same random input at each step: its output and its cache blocks
    against the whole layer's decode and cache, in float32 within
    ``LAYER_TOL``; no layer runs whole."""
    cfg = reduced(arch)
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    mesh = mesh_of(1, T)
    compute = steps.MeshCompute(bundle, mesh)
    params = placed(model, mesh)
    group = compute.group(0)
    local = {m: compute.serving_replica(CPU, params, m) for m in range(T)}
    assert compute.plan(0).whole == []
    B = 2
    single = random_cross(bundle.init_cache(B, max_len, device=CPU))
    cache = ts.shard_cache(random_cross(bundle.init_cache(B, max_len,
                                                          device=CPU)), mesh)
    whole = decoder_layers(model)
    ranks = {m: decoder_layers(local[m]) for m in range(T)}
    want_c = layer_cache_list(cfg, single)
    got_c = {m: layer_cache_list(cfg, tp.cache_blocks(cache, (0, m)))
             for m in range(T)}
    gen = torch.Generator().manual_seed(1)
    for t in range(n_steps):
        pos = torch.tensor(t)
        for i, layer in enumerate(whole):
            x = torch.randn((B, 1, cfg.d_model), generator=gen)
            want = layer.decode(x, want_c[i], pos)
            ls = {m: ranks[m][i] for m in range(T)}
            cs = {m: got_c[m][i] for m in range(T)}
            if cfg.n_enc_layers:
                got = encdec.dec_layer_decode_tp(group, ls, {CPU: x}, cs,
                                                 {CPU: pos})
            else:
                run = tp.DecodeRun(0, group, local, {}, {}, {CPU: pos},
                                   slice(0, B))
                got = lm.layer_decode_tp([run], {0: ls}, {0: {CPU: x}},
                                         {0: cs}, 1)[0]
            assert torch.allclose(got[CPU], want, **LAYER_TOL), (
                arch, t, i, (got[CPU] - want).abs().max().item())
    cache_close(single, cache, arch, LAYER_TOL["atol"])


def combine(parts, dtype):
    """The slices combined as a model group combines them: the max over
    the slices, the rescaled sums and values added in order, divided
    once."""
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    scaled = [layers.rescale_partial(*p, m_all) for p in parts]
    l_sum, acc = scaled[0]
    for l, a in scaled[1:]:
        l_sum, acc = l_sum + l, acc + a
    return layers.finish_partials(l_sum, acc, dtype)


def test_masked_slice_adds_nothing_to_the_combine():
    """A cache slice with no visible position (early in a long cache: its
    positions all lie past ``cur_len``) gives ``m = NEG`` and zero sum and
    values, and the combine with it is bitwise the combine without it;
    the slices' combine equals ``decode_attention`` within 1e-6."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 16), generator=gen)
    k = torch.randn((2, 12, 2, 16), generator=gen)
    v = torch.randn((2, 12, 2, 16), generator=gen)
    cur = torch.tensor(5)
    parts = [layers.decode_attention_partial(q, k[:, a:a + 4], v[:, a:a + 4],
                                             cur, a) for a in (0, 4, 8)]
    m, l, acc = parts[2]
    assert bool((m == layers.NEG).all())
    assert not l.any() and not acc.any()
    both = combine(parts[:2], q.dtype)
    assert torch.equal(combine(parts, q.dtype), both)
    want = layers.decode_attention(q, k, v, cur)
    assert torch.allclose(both, want, rtol=1e-6, atol=1e-6)


def test_one_rank_group_is_the_attention_decode_bitwise():
    """On a group of one rank the attention's decode goes through
    ``Attention.decode`` itself (the existing ``decode_attention``, not
    the split-KV combine): output and cache bitwise."""
    cfg = reduced("qwen2.5-3b")
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    mesh = mesh_of(1, 1)
    compute = steps.MeshCompute(bundle, mesh)
    local = compute.serving_replica(CPU, placed(model, mesh), 0)
    group = compute.group(0)
    single = bundle.init_cache(2, 8, device=CPU)
    cache = ts.shard_cache(bundle.init_cache(2, 8, device=CPU), mesh)
    blocks = lm.layer_caches(cfg, tp.cache_blocks(cache, (0, 0)))[0]
    gen = torch.Generator().manual_seed(2)
    for t in range(4):
        x = torch.randn((2, 1, cfg.d_model), generator=gen)
        pos = torch.tensor(t)
        want = model.layers()[0].mixer.decode(
            x, lm.layer_caches(cfg, single)[0], pos)
        got = mixers.decode_tp(group, {0: local.layers()[0].mixer},
                               {0: x}, {0: blocks}, {CPU: pos}, x.dtype)
        assert torch.equal(got[CPU], want)
    assert torch.equal(ts.unshard(ts.tree_leaves(cache)[
        "cycles.0.layer0.k"], CPU), single["cycles"][0]["layer0"]["k"])


# ------------------------------------------------------------ whole loops
def teacher_forced(bundle, model, mesh, tokens, max_len):
    """The single-device decode's logits and cache, and the mesh's, over
    the same tokens (the mesh fed the tokens too, not its own argmax)."""
    B, n = tokens.shape
    single = random_cross(bundle.init_cache(B, max_len, device=CPU))
    cache = ts.shard_cache(random_cross(bundle.init_cache(B, max_len,
                                                          device=CPU)), mesh)
    step = steps.make_serve_step(bundle, mesh)
    params = placed(model, mesh)
    out = []
    for t in range(n):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        a, single = bundle.decode_step(model, single, tok, t)
        b, cache = step(params, cache, {"tokens": tok, "pos": t})
        out.append((a, b))
    return out, single, cache, step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_loop_on_a_mesh_matches_one_device(arch, dtype):
    """Eight teacher-forced steps of reduced ``arch`` (batch 4, cache 16)
    on ``(data 2, model 2)``: the logits at every step within 1e-5
    (float32) or 5e-2 (bfloat16) of the single-device decode, and every
    stored cache block within the same of its region of the single-device
    cache; on ``(1, 1)`` both bitwise."""
    cfg = reduced(arch, dtype)
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 8))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    out, single, cache, step = teacher_forced(bundle, model, mesh_of(2, 2),
                                              tokens, 16)
    for t, (a, b) in enumerate(out):
        assert b.shape == a.shape == (4, cfg.vocab)
        err = (a.float() - b.float()).abs().max().item()
        assert err < tol, (arch, t, err)
    cache_close(single, cache, arch, tol)
    assert step.compute.tallies[0].total("all-reduce") > 0
    out, single, cache, _ = teacher_forced(bundle, model, mesh_of(1, 1),
                                           tokens[:, :4], 16)
    assert all(torch.equal(a, b) for a, b in out)
    for path, leaf in ts.tree_leaves(cache).items():
        assert torch.equal(ts.unshard(leaf, CPU),
                           ts.tree_leaves(single)[path]), path


def test_batch_the_data_axes_do_not_divide_runs_on_rank_0():
    """Three rows on ``(data 2, model 2)``: the batch is replicated over the
    data axes (``batch_spec``), so only data rank 0's group runs (one
    tally), within 1e-5 of one device, its cache blocks equal to the
    single-device cache's."""
    cfg = reduced("qwen2.5-3b")
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (3, 6))
    out, single, cache, step = teacher_forced(bundle, model, mesh_of(2, 2),
                                              tokens, 8)
    assert list(step.compute.tallies) == [0]
    for a, b in out:
        assert (a - b).abs().max().item() < F32_TOL
    cache_close(single, cache, "3 rows", F32_TOL)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium"])
def test_layers_that_run_whole_gather_and_write_back_their_cache(arch):
    """On ``(1, 8)`` the reduced archs' 4 attention (MLA, cross-attention)
    heads do not divide: those layers run whole (``Plan.whole``), each
    split cache leaf of theirs gathered for the step and written back,
    tallied in the "cache" phase; the logits within 1e-5 of one device's
    and every cache block equal to its region."""
    cfg = reduced(arch)
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 6))
    out, single, cache, step = teacher_forced(bundle, model, mesh_of(1, 8),
                                              tokens, 16)
    assert step.compute.plan(0).whole
    for a, b in out:
        assert (a - b).abs().max().item() < F32_TOL
    cache_close(single, cache, arch, F32_TOL)
    if arch != "deepseek-v2-lite-16b":         # MLA's cache is whole
        assert step.compute.tallies[0].bytes[("all-gather", "cache")] > 0


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_moe_drops_over_data_ranks_equal_one_device(shape):
    """Reduced deepseek-v2-lite-16b at batch 4 decodes with capacity 1 per
    expert, so choices collide and drop.  On ``(data 2, model 2)`` (experts
    split) and ``(data 2, model 1)`` (the layer whole on each group) each
    group routes the whole batch (both data ranks' rows gathered): every
    routing's dropped choices equal the single-device decode's, layer by
    layer and step by step, and the logits stay within 1e-5."""
    cfg = reduced("deepseek-v2-lite-16b")
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    assert ffn.moe_capacity(cfg, 4) == 1
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 6))
    drops = []
    route = ffn.moe_route

    def recording(m, xf):
        out = route(m, xf)
        drops.append(out.order == cfg.n_experts * out.cap)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ffn, "moe_route", recording)
    try:
        out, _, _, _ = teacher_forced(bundle, model, mesh_of(*shape), tokens,
                                      8)
    finally:
        mp.undo()
    # each step: the single-device decode's routing of each MoE layer,
    # then the mesh's, one a rank of each group
    n = shape[0] * shape[1]
    n_moe = sum(isinstance(layer.ffn, ffn.MoEFFN) for layer in model.layers())
    assert n_moe and len(drops) == len(out) * n_moe * (1 + n)
    total = 0
    for t in range(len(out)):
        step = drops[t * n_moe * (1 + n):(t + 1) * n_moe * (1 + n)]
        for i, want in enumerate(step[:n_moe]):
            total += int(want.sum())
            for got in step[n_moe + n * i:n_moe + n * (i + 1)]:
                assert torch.equal(got, want), (t, i)
    assert total > 0
    for a, b in out:
        assert (a - b).abs().max().item() < F32_TOL


def test_captured_mesh_decode_equals_the_eager_step():
    """``CapturedDecode(bundle, serve_step)`` on the CPU runs its static-input
    body uncaptured: the same logits and cache blocks as the eager mesh
    step, step by step, on ``(data 2, model 2)``."""
    cfg = reduced("recurrentgemma-9b")
    bundle = build_model(cfg)
    model = bundle.init(0, CPU)
    mesh = mesh_of(2, 2)
    params = placed(model, mesh)
    step = steps.make_serve_step(bundle, mesh)
    decode = steps.CapturedDecode(bundle, steps.make_serve_step(bundle,
                                                                mesh))
    c1 = ts.shard_cache(bundle.init_cache(4, 8, device=CPU), mesh)
    c2 = ts.shard_cache(bundle.init_cache(4, 8, device=CPU), mesh)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (4, 8))
    for t in range(8):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        a, c1 = decode(params, c1, tok, t)
        b, c2 = step(params, c2, {"tokens": tok, "pos": t})
        assert torch.equal(a, b)
    for x, y in zip(steps.cache_leaves(c1), steps.cache_leaves(c2)):
        assert torch.equal(x, y)
    assert decode.captures == 0 and len(decode._steps) == 1


# ------------------------------------------------------------ the reference
REF_ARCHS = ("qwen2.5-3b", "recurrentgemma-9b", "mamba2-780m",
             "deepseek-v2-lite-16b", "seamless-m4t-medium")
REF_B, REF_LEN, REF_STEPS = 8, 16, 6
_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import ARCHS
    from repro.configs.reduced import reduce_config
    from repro.models.registry import build_model
    from repro.launch.mesh import make_mesh_for_devices
    from repro.launch.steps import make_serve_step
    from repro.distributed.sharding import (batch_shardings,
                                            cache_shardings,
                                            params_shardings)

    B, L, N = json.loads(sys.argv[3])
    out = {}
    mesh = make_mesh_for_devices(8, model_parallel=2)
    for arch in json.loads(sys.argv[2]):
        cfg = dataclasses.replace(reduce_config(ARCHS[arch]),
                                  dtype="float32")
        bundle = build_model(cfg)
        params = bundle.init(jax.random.PRNGKey(0))
        cache = bundle.init_cache(B, L)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab, (B, N)).astype(np.int32)
        cross = {}
        if cfg.n_enc_layers:
            for name in ("cross_k", "cross_v"):
                cross[name] = rng.normal(size=cache["dec"][name].shape
                                         ).astype(np.float32)
                cache["dec"][name] = jnp.asarray(cross[name])
        init = jax.tree.map(np.asarray, params)
        logits = []
        with mesh:
            p_sh = params_shardings(params, mesh)
            c_sh = cache_shardings(cache, mesh)
            params = jax.device_put(params, p_sh)
            cache = jax.device_put(cache, c_sh)
            batch = {"tokens": jnp.asarray(tokens[:, :1]),
                     "pos": jnp.asarray(0, jnp.int32)}
            step = jax.jit(make_serve_step(bundle), in_shardings=(
                p_sh, c_sh, batch_shardings(batch, mesh)))
            for t in range(N):
                batch = {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                         "pos": jnp.asarray(t, jnp.int32)}
                out_t, cache = step(params, cache, batch)
                logits.append(np.asarray(out_t))
        out[arch] = {"init": init, "tokens": tokens, "cross": cross,
                     "logits": logits}
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
    print("RESULT:" + json.dumps({"ok": True}))
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_tp_decode") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(path), json.dumps(REF_ARCHS),
         json.dumps([REF_B, REF_LEN, REF_STEPS])],
        env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as fh:          # written by the script above
        return pickle.load(fh)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_mesh_decode_matches_the_reference_sharded_serve_step(ref, arch):
    """The port's mesh decode on ``(data 4, model 2)`` from the
    reference's parameters (``params_from_jax``) and tokens against the
    reference's sharded serve step on the same mesh shape: logits within
    1e-4 at every step, in float32."""
    got = ref[arch]
    cfg = reduced(arch)
    bundle = build_model(cfg)
    model = bundle.params_from_jax(got["init"], device=CPU)
    cache = bundle.init_cache(REF_B, REF_LEN, device=CPU)
    for name, arr in got["cross"].items():
        for i, c in enumerate(cache["dec"]):
            c[name].copy_(torch.as_tensor(arr[i]))
    mesh = mesh_of(4, 2)
    step = steps.make_serve_step(bundle, mesh)
    params = placed(model, mesh)
    cache = ts.shard_cache(cache, mesh)
    for t, want in enumerate(got["logits"]):
        tok = torch.as_tensor(got["tokens"][:, t:t + 1]).long()
        logits, cache = step(params, cache, {"tokens": tok, "pos": t})
        np.testing.assert_allclose(logits.numpy(), want, rtol=REF_TOL,
                                   atol=REF_TOL, err_msg=f"{arch} step {t}")
