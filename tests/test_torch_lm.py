"""The port's LM serving path against the JAX reference on the CPU, for
every architecture of ``ARCHS`` at ``reduce_config``: parameters made by
the reference's ``init`` and carried over by ``params_from_jax``, then the
full forward, the prefill step and 8 decode steps (logits and caches),
in float32 at rtol = atol = 1e-4 with equal greedy tokens, and in the
config's bfloat16 at 5e-2; the port's own decode == forward as
``tests/test_arch_smoke.py`` checks the reference's; the configs, the
MoE dispatch report and the serve CLI.

The reference runs compiled (``jax.jit``) with XLA's excess precision
off, so that each bfloat16 op rounds as written, as the port's ops (and
the reference's own ops run one by one) do.  With it on, XLA keeps fused
bfloat16 chains in float32, and the compiled reference moves away from
its own op-by-op arithmetic by up to 0.067 on reduced recurrentgemma;
with it off, the port's bfloat16 forward equals the reference's bitwise
for seven of the ten archs."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import SUBQUADRATIC as REF_SUBQUADRATIC
from repro.configs.reduced import reduce_config as ref_reduce
from repro.launch import steps as ref_steps
from repro.models import ffn as ref_ffn
from repro.models.registry import build_model as ref_build
from repro_torch.configs import ARCHS, SHAPES, SUBQUADRATIC
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import steps
from repro_torch.models import ffn
from repro_torch.models.registry import build_model

ARCH_IDS = list(ARCHS)
CPU = torch.device("cpu")
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)
B, L, N_PROMPT, N_STEPS, MAX_LEN = 2, 16, 4, 8, 16


def _configs(arch, dtype):
    cfg, ref = reduce_config(ARCHS[arch]), ref_reduce(REF_ARCHS[arch])
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        ref = dataclasses.replace(ref, dtype=dtype)
    return cfg, ref


@functools.lru_cache(maxsize=None)
def _models(arch, dtype=None, seed=0):
    """(port bundle, port model, reference bundle, reference params as
    jnp arrays), the port's parameters carried over from the
    reference's (``init(PRNGKey(seed))``)."""
    cfg, ref = _configs(arch, dtype)
    rb = ref_build(ref)
    rp = rb.init(jax.random.PRNGKey(seed))
    tb = build_model(cfg)
    model = tb.params_from_jax(jax.tree.map(np.asarray, rp), device=CPU)
    return tb, model, rb, rp


def _batch(cfg, seed=0):
    """numpy inputs as tests/test_arch_smoke.py::_batch makes them: frames
    for the enc-dec arch, a frontend-stub prefix and M-RoPE positions for
    the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frames": rng.normal(size=(B, L, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}
    if cfg.frontend_prefix > 0:
        lp = int(L * cfg.frontend_prefix)
        pos = np.broadcast_to(np.arange(L)[None, :, None], (B, L, 3)).copy()
        return {"embeds": rng.normal(size=(B, lp, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, L - lp))
                .astype(np.int32),
                "positions": pos.astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)}


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol,
                               err_msg=what)


def _paths(tree, prefix=""):
    """{dotted path: leaf} of a nested dict / list pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_paths(v, f"{prefix}{k}."))
    return out


def _ref_cache_paths(cache):
    """The reference's cache as {path: array} in the port's layout: its
    stacked ``cycles`` / ``dec`` entries unstacked along the layer axis."""
    out = {}
    for key, val in cache.items():
        if key in ("cycles", "dec"):
            n = len(jax.tree.leaves(val)[0])
            val = [jax.tree.map(lambda a, i=i: np.asarray(a)[i], val)
                   for i in range(n)]
        out.update(_paths(val, f"{key}."))
    return out


def _decode_both(arch, dtype, greedy):
    """N_STEPS decode steps through both packages: the prompt's tokens for
    N_PROMPT steps, then each package's own greedy token (``greedy``) or
    the prompt's.  Returns per-step (port logits, reference logits, port
    token, reference token) and the two final caches."""
    tb, model, rb, rp = _models(arch, dtype)
    toks = np.random.default_rng(1).integers(0, tb.cfg.vocab, (B, N_STEPS))
    cache = tb.init_cache(B, MAX_LEN, device=CPU)
    rcache = rb.init_cache(B, MAX_LEN)
    rdecode = _compiled(rb.decode_step, rp, rcache,
                        jnp.zeros((B, 1), jnp.int32), jnp.int32(0))
    steps_out = []
    tok = rtok = toks[:, :1]
    for t in range(N_STEPS):
        logits, cache = tb.decode_step(model, cache, torch.as_tensor(tok), t)
        rlogits, rcache = rdecode(rp, rcache, jnp.asarray(rtok, jnp.int32),
                                  jnp.int32(t))
        nxt = logits.float().argmax(-1)[:, None].numpy()
        rnxt = np.asarray(jnp.argmax(rlogits.astype(jnp.float32), -1))[:, None]
        steps_out.append((logits, rlogits, nxt, rnxt))
        if greedy and t + 1 >= N_PROMPT:
            tok, rtok = nxt, rnxt
        elif t + 1 < N_STEPS:
            tok = rtok = toks[:, t + 1:t + 2]
    return steps_out, _paths(cache), _ref_cache_paths(rcache)


# ----------------------------------------------------------------- configs
def test_configs_equal_the_reference():
    assert list(ARCHS) == list(REF_ARCHS)
    for arch in ARCHS:
        for port, ref in ((ARCHS[arch], REF_ARCHS[arch]),
                          (reduce_config(ARCHS[arch]),
                           ref_reduce(REF_ARCHS[arch]))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert (port.padded_vocab, port.resolved_head_dim,
                    port.param_count(), port.param_count(True)) == (
                ref.padded_vocab, ref.resolved_head_dim, ref.param_count(),
                ref.param_count(True))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert SUBQUADRATIC == REF_SUBQUADRATIC


def test_gnn_paper_config_points_at_the_port():
    from repro.configs import gnn_paper as ref
    from repro_torch.configs import gnn_paper
    from repro_torch.data import graphs
    from repro_torch.models import gnn
    assert gnn_paper.GNN_MODELS is gnn.MODELS
    assert gnn_paper.GNN_DATASETS == tuple(graphs.DATASETS)
    assert (gnn_paper.GNN_MODELS, gnn_paper.GNN_DATASETS) == (
        ref.GNN_MODELS, ref.GNN_DATASETS)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if ARCHS[a].ffn == "moe"])
@pytest.mark.parametrize("tokens", [2, 4, 4096])
def test_moe_dispatch_report_equals_the_reference(arch, tokens):
    for cfg, ref in ((ARCHS[arch], REF_ARCHS[arch]),
                     (reduce_config(ARCHS[arch]),
                      ref_reduce(REF_ARCHS[arch]))):
        assert ffn.moe_dispatch_report(cfg, tokens) == (
            ref_ffn.moe_dispatch_report(ref, tokens))


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_prefill_match_the_reference_f32(arch):
    tb, model, rb, rp = _models(arch, "float32")
    batch = _batch(tb.cfg)
    got = tb.forward(model, _port_batch(batch))
    want = _compiled(rb.forward, rp, _ref_batch(batch))(rp, _ref_batch(batch))
    assert tuple(got.shape) == want.shape
    assert got.shape[-1] == tb.cfg.padded_vocab
    _close(got, want, F32, arch)
    got = steps.make_prefill_step(tb)(model, _port_batch(batch))
    want = _compiled(ref_steps.make_prefill_step(rb), rp,
                     _ref_batch(batch))(rp, _ref_batch(batch))
    _close(got, want, F32, arch + " prefill")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_the_reference_f32(arch):
    """8 steps (4 of prompt, then greedy): logits within 1e-4, the greedy
    tokens equal, and every cache leaf within 1e-4 after the last."""
    out, cache, rcache = _decode_both(arch, "float32", greedy=True)
    for t, (logits, rlogits, nxt, rnxt) in enumerate(out):
        assert tuple(logits.shape) == (B, 256) == rlogits.shape
        _close(logits, rlogits, F32, f"{arch} step {t}")
        np.testing.assert_array_equal(nxt, rnxt, err_msg=f"{arch} step {t}")
    assert sorted(cache) == sorted(rcache)
    for path, c in cache.items():
        assert tuple(c.shape) == rcache[path].shape, path
        _close(c, rcache[path], F32, f"{arch} cache {path}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_forward_and_decode_match_the_reference(arch):
    """The config's own bfloat16 compute, at the looser of the reference's
    decode-vs-forward tolerances; no token comparison."""
    tb, model, rb, rp = _models(arch)
    assert tb.cfg.dtype == "bfloat16"
    batch = _batch(tb.cfg)
    got = tb.forward(model, _port_batch(batch))
    assert got.dtype == torch.bfloat16
    rbatch = _ref_batch(batch)
    _close(got, _compiled(rb.forward, rp, rbatch)(rp, rbatch), BF16, arch)
    out, _, _ = _decode_both(arch, None, greedy=False)
    for t, (logits, rlogits, _, _) in enumerate(out):
        _close(logits, rlogits, BF16, f"{arch} step {t}")


# (arch, tolerance, seed) of tests/test_arch_smoke.py's decode-vs-forward
# checks (dense: tolerance 2e-2, parameters and tokens from seed 3;
# recurrent: 5e-2, seed 4), over every decoder-only arch without MoE
# (capacity drops at decode differ from the forward's by design)
DECODE_FORWARD = [(a, 5e-2, 4) if {"rglru", "ssd"} & set(ARCHS[a].mixer_pattern)
                  else (a, 2e-2, 3)
                  for a in ARCH_IDS if ARCHS[a].ffn != "moe"
                  and not ARCHS[a].n_enc_layers]


@pytest.mark.parametrize("arch,tol,seed", DECODE_FORWARD)
def test_port_decode_equals_its_forward(arch, tol, seed):
    tb, model, _, _ = _models(arch, seed=seed)
    toks = np.random.default_rng(seed).integers(0, tb.cfg.vocab, (1, 8))
    full = tb.forward(model, {"tokens": torch.as_tensor(toks)}).float()
    cache = tb.init_cache(1, 16, device=CPU)
    for t in range(8):
        logits, cache = tb.decode_step(model, cache,
                                       torch.as_tensor(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(logits[0].float().numpy(),
                                   full[0, t, :tb.cfg.vocab].numpy(),
                                   rtol=tol, atol=tol, err_msg=f"{arch} {t}")


# ----------------------------------------------------------------- serving
def test_captured_decode_runs_the_step_body_on_the_cpu():
    """``CapturedDecode`` on the CPU runs its static-input body uncaptured:
    the same logits and cache as the plain decode step, a copy of the
    logits per call, and a position past the cache refused."""
    tb, model, _, _ = _models("recurrentgemma-9b", "float32")
    toks = np.random.default_rng(5).integers(0, tb.cfg.vocab, (B, 7))
    decode = steps.CapturedDecode(tb)
    serve_step = steps.make_serve_step(tb)
    c1 = tb.init_cache(B, 6, device=CPU)
    c2 = tb.init_cache(B, 6, device=CPU)
    kept = []
    for t in range(6):
        tok = torch.as_tensor(toks[:, t:t + 1])
        a, c1 = decode(model, c1, tok, t)
        b, c2 = serve_step(model, c2, {"tokens": tok, "pos": t})
        assert torch.equal(a, b)
        kept.append(a)
    assert all(not torch.equal(kept[0], k) for k in kept[1:])
    for x, y in zip(steps.cache_leaves(c1), steps.cache_leaves(c2)):
        assert torch.equal(x, y)
    assert decode.captures == 0 and len(decode._steps) == 1
    # the local-attention ring buffer wraps: position 6 of a 6-deep cache
    # is slot 0
    decode(model, c1, torch.as_tensor(toks[:, 6:]), 6)
    qb, qmodel, _, _ = _models("qwen2.5-3b", "float32")
    cache = qb.init_cache(B, 6, device=CPU)
    for step in (qb.decode_step, steps.CapturedDecode(qb)):
        with pytest.raises(ValueError, match="outside the cache"):
            step(qmodel, cache, torch.as_tensor(toks[:, :1]), 6)


def test_bundle_builds_shape_only_trees():
    """``abstract_params`` is the model on the ``meta`` device (no memory,
    no values) and ``abstract_cache`` the decode cache there, of
    ``init``'s and ``init_cache``'s shapes and dtypes; ``loss`` (the
    training slice) is the model's ``lm_loss``."""
    from repro_torch.models import lm

    bundle = build_model(reduce_config(ARCHS["qwen2.5-3b"]))
    model = bundle.abstract_params()
    real = bundle.init(0, CPU)
    assert isinstance(model, lm.LM)
    assert [(n, p.shape, p.dtype) for n, p in model.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in real.named_parameters()]
    assert all(p.is_meta for p in model.parameters())
    cache = steps.cache_leaves(bundle.abstract_cache(2, 16))
    want = steps.cache_leaves(bundle.init_cache(2, 16, device=CPU))
    assert [(t.shape, t.dtype) for t in cache] == [(t.shape, t.dtype)
                                                   for t in want]
    assert all(t.is_meta for t in cache)
    assert bundle.loss is lm.lm_loss


def test_serve_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve`` with ``--device cpu`` on the
    reduced MoE arch: the analyzer line and the generated-tokens line in
    the reference's format, the analyzer's numbers the reference's."""
    from repro_torch.launch import serve

    serve.main(["--arch", "deepseek-v2-lite-16b", "--batch", "2",
                "--prompt-len", "8", "--gen", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    rep = ref_ffn.moe_dispatch_report(
        ref_reduce(REF_ARCHS["deepseek-v2-lite-16b"]), tokens=2)
    assert out[0] == (
        f"[serve] MoE dispatch analyzer: density {rep['density']:.3f} -> "
        f"{rep['primitive']} (t_sparse {rep['t_sparse']:.2e}s vs t_dense "
        f"{rep['t_dense']:.2e}s)")
    assert out[1].startswith("[serve] deepseek-v2-lite-16b: generated (2, 8)")
    assert out[2].startswith("[serve] sample: [")
    sample = eval(out[2].split(": ", 1)[1])
    assert len(sample) == 8 and all(0 <= s < 256 for s in sample)


def test_moe_sparse_dispatch_matches_the_reference_example():
    """``chip_smoke.py``'s LM-MoE operands are ``examples/
    moe_sparse_dispatch.py``'s (same mask and seed; the float32 cast is
    exact), and the port's ``pack_blockcsr`` + ``ops.spdmm`` gives the
    example's interpret-mode ``ops.spdmm`` result."""
    import importlib.util
    import runpy
    from pathlib import Path

    from repro_torch.kernels import ops
    from repro_torch.kernels.formats import pack_blockcsr

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    example = runpy.run_path(str(root / "examples" /
                                 "moe_sparse_dispatch.py"))
    acts, w, block = smoke.moe_dispatch_operands()
    np.testing.assert_array_equal(acts, example["acts"])
    np.testing.assert_array_equal(w, example["w"])
    a = pack_blockcsr(torch.as_tensor(acts), block)
    assert (a.nnzb, a.block_density()) == (
        example["a_sparse"].nnzb, example["a_sparse"].block_density())
    got = ops.spdmm(a, torch.as_tensor(w))
    _close(got, example["z_sparse"], F32, "spdmm")
    _close(got, acts @ w, F32, "dense")
