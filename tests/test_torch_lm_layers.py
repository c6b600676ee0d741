"""The port's LM building blocks (``repro_torch.models.{layers,mixers,
ffn}``) against their JAX counterparts on the same seeded numpy inputs,
float32 at rtol = atol = 1e-4: flash attention in every mode of
``tests/test_layers.py`` (causal, window, GQA 4/1 and 8/2, ragged lengths
that need padding, ``causal_skip``, a query offset and a kv-length mask),
decode attention, RoPE and M-RoPE, the norms, the MoE FFN with and
without capacity drops (and the reference's own per-token check), the
chunked SSD scan against its step recurrence, the RG-LRU scan, and each
mixer's forward and decode step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import ffn as rffn
from repro.models import layers as rl
from repro.models import mixers as rm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tl
from repro_torch.models import mixers as tm
from repro_torch.models.layers import make_compute_copies
from repro_torch.models.lm import load_tree

TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **TOL,
                               err_msg=what)


def _t(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1), (8, 2)])
def test_flash_attention_matches_the_reference(causal, window, hq, hkv):
    rng = _rng(hq * 10 + hkv + (window or 0))
    B, L, Dh = 2, 40, 16                     # 40: ragged against both chunks
    q, k, v = (_normal(rng, B, L, h, Dh) for h in (hq, hkv, hkv))
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=8)
    got = tl.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    _close(got, want)


def test_flash_causal_skip_equals_the_full_scan():
    rng = _rng(1)
    q, k, v = (_normal(rng, 1, 64, 2, 8) for _ in range(3))
    a = tl.flash_attention(_t(q), _t(k), _t(v), q_chunk=16, kv_chunk=16)
    b = tl.flash_attention(_t(q), _t(k), _t(v), q_chunk=16, kv_chunk=16,
                           causal_skip=True)
    assert torch.equal(a, b)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_chunk=16, kv_chunk=16, causal_skip=True)
    _close(b, want)


def test_flash_query_offset_and_kv_length_mask():
    """A prefill tail: 12 queries at position 20 against 40 cached keys of
    which the first 32 are valid."""
    rng = _rng(2)
    q = _normal(rng, 2, 12, 4, 16)
    k, v = _normal(rng, 2, 40, 2, 16), _normal(rng, 2, 40, 2, 16)
    kw = dict(q_offset=20, kv_len_mask=32, q_chunk=8, kv_chunk=16)
    got = tl.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = rl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **kw)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("cur_len", [1, 9, 16])
def test_decode_attention_matches_the_reference(window, cur_len):
    rng = _rng(cur_len)
    q = _normal(rng, 2, 1, 8, 16)
    kc, vc = _normal(rng, 2, 16, 2, 16), _normal(rng, 2, 16, 2, 16)
    got = tl.decode_attention(_t(q), _t(kc), _t(vc), torch.tensor(cur_len),
                              window=window)
    want = rl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.int32(cur_len),
                               window=window)
    _close(got, want)


# ----------------------------------------------------------------- RoPE, norms
def test_rope_matches_the_reference():
    rng = _rng(3)
    x = _normal(rng, 2, 6, 3, 16)
    pos = rng.integers(0, 1000, (2, 6))
    _close(tl.apply_rope(_t(x), _t(pos), 1e4),
           rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


def test_mrope_matches_the_reference():
    rng = _rng(4)
    x = _normal(rng, 2, 6, 3, 16)
    pos = rng.integers(0, 50, (2, 6, 3))
    _close(tl.apply_rope(_t(x), _t(pos), 1e6, sections=(2, 3, 3)),
           rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                         sections=(2, 3, 3)))
    # with the three streams equal, M-RoPE is classic RoPE
    same = np.repeat(pos[..., :1], 3, axis=-1)
    _close(tl.apply_rope(_t(x), _t(same), 1e6, sections=(2, 3, 3)),
           tl.apply_rope(_t(x), _t(same[..., 0]), 1e6).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_the_reference(dtype):
    rng = _rng(5)
    x = _normal(rng, 3, 7, 32, scale=3.0)
    w, b = _normal(rng, 32), _normal(rng, 32)
    xt = _t(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(dtype)
    for got, want in ((tl.rms_norm(xt, _t(w)), rl.rms_norm(xj, w)),
                      (tl.layer_norm(xt, _t(w), _t(b)),
                       rl.layer_norm(xj, w, b))):
        assert got.dtype == xt.dtype
        if dtype == "bfloat16":       # float32 inside, one rounding: equal
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["swiglu", "geglu"])
def test_dense_ffn_matches_the_reference(fn):
    rng = _rng(6)
    x = _normal(rng, 2, 5, 16)
    ws = _normal(rng, 16, 24), _normal(rng, 16, 24), _normal(rng, 24, 16)
    _close(getattr(tl, fn)(_t(x), *map(_t, ws)),
           getattr(rl, fn)(jnp.asarray(x), *ws))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_round_as_the_reference(dtype):
    """silu and the tanh gelu written out as jax.nn's formulas: bitwise
    jax's in bfloat16 (each op rounds), within 1e-6 in float32."""
    x = _normal(_rng(7), 4096, scale=3.0)
    xt, xj = _t(x).to(getattr(torch, dtype)), jnp.asarray(x).astype(dtype)
    for got, want in ((tl.silu(xt), jax.nn.silu(xj)),
                      (tl.gelu(xt), jax.nn.gelu(xj))):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- MoE
def _moe_cfg(cls, **kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=0, vocab=32, ffn="moe", n_experts=4,
                n_shared_experts=1, top_k=2, moe_d_ff=8, dtype="float32")
    return cls(**{**base, **kw})


def _moe_pair(seed, **kw):
    ref_cfg, cfg = _moe_cfg(RefModelConfig, **kw), _moe_cfg(ModelConfig, **kw)
    p = rffn.init_moe_ffn(jax.random.PRNGKey(seed), ref_cfg)
    m = tffn.MoEFFN(cfg)
    load_tree(m, jax.tree.map(np.asarray, p))
    return ref_cfg, p, m


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0, 0.5])
def test_moe_ffn_matches_the_reference(capacity_factor):
    """No drops (8.0), some (1.0), many (0.5): the same tokens keep the
    same slots, and the weighted sums agree."""
    ref_cfg, p, m = _moe_pair(0, capacity_factor=capacity_factor)
    x = _normal(_rng(8), 2, 12, 16, scale=0.5)
    _close(tffn.moe_ffn(m, _t(x)), rffn.moe_ffn(p, jnp.asarray(x), ref_cfg))


def test_moe_capacity_drops_happen():
    """At capacity factor 0.5 the slot table holds fewer choices than the
    tokens make, so the output differs from the undropped one."""
    ref_cfg, p, m = _moe_pair(0, capacity_factor=0.5)
    _, _, m_full = _moe_pair(0, capacity_factor=8.0)
    x = _t(_normal(_rng(8), 2, 12, 16, scale=0.5))
    assert tffn.moe_capacity(m.cfg, 24) == 6 < 24 * 2 // 4
    assert not torch.allclose(tffn.moe_ffn(m, x), tffn.moe_ffn(m_full, x))


def _naive_moe(p, x, cfg):
    """Per-token loop of tests/test_layers.py (no capacity drops)."""
    T, D = x.shape
    logits = x @ np.asarray(p["router"], np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    out = np.zeros((T, D), np.float32)
    for t in range(T):
        top = np.argsort(-probs[t])[:cfg.top_k]
        w = probs[t][top] / probs[t][top].sum()
        for e, wi in zip(top, w):
            g = x[t] @ np.asarray(p["w_gate"][e], np.float32)
            u = x[t] @ np.asarray(p["w_up"][e], np.float32)
            out[t] += wi * ((g / (1 + np.exp(-g)) * u)
                            @ np.asarray(p["w_down"][e], np.float32))
    sp = p["shared"]
    g = x @ np.asarray(sp["w_gate"], np.float32)
    u = x @ np.asarray(sp["w_up"], np.float32)
    return out + (g / (1 + np.exp(-g)) * u) @ np.asarray(sp["w_down"],
                                                         np.float32)


def test_moe_matches_the_per_token_reference():
    ref_cfg, p, m = _moe_pair(0, capacity_factor=8.0)
    x = _normal(_rng(42), 1, 12, 16, scale=0.5)
    got = tffn.moe_ffn(m, _t(x))[0].numpy()
    np.testing.assert_allclose(got, _naive_moe(p, x[0], ref_cfg), rtol=2e-3,
                               atol=2e-3)


# ----------------------------------------------------------------- scans
def test_ssd_scan_matches_the_reference_and_the_step_recurrence():
    """The chunked scan (chunk 8 over 21 positions: padded) against the
    reference's, and against S_t = exp(dA_t) S_{t-1} + x_t (x) B_t,
    y_t = C_t S_t."""
    rng = _rng(9)
    b, l, h, p, n = 2, 21, 3, 4, 5
    x = _normal(rng, b, l, h, p)
    dA = -np.abs(_normal(rng, b, l, h, scale=0.3))
    Bm, Cm = _normal(rng, b, l, n), _normal(rng, b, l, n)
    got = tm.ssd_scan(_t(x), _t(dA), _t(Bm), _t(Cm), 8)
    _close(got, rm._ssd_scan(jnp.asarray(x), jnp.asarray(dA),
                             jnp.asarray(Bm), jnp.asarray(Cm), 8))
    s = np.zeros((b, h, p, n), np.float64)
    want = np.zeros((b, l, h, p))
    for t in range(l):
        s = (s * np.exp(dA[:, t])[..., None, None]
             + np.einsum("bhp,bn->bhpn", x[:, t], Bm[:, t]))
        want[:, t] = np.einsum("bhpn,bn->bhp", s, Cm[:, t])
    _close(got, want)


def test_lru_scan_matches_the_associative_scan():
    rng = _rng(10)
    a = rng.uniform(0.5, 1.0, (2, 30, 8)).astype(np.float32)
    g = _normal(rng, 2, 30, 8)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(g)), axis=1)
    _close(tm.lru_scan(_t(a), _t(g)), want)


# ----------------------------------------------------------------- mixers
MIXER_CFG = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                 n_kv_heads=2, d_ff=64, vocab=64, head_dim=8, dtype="float32")
MIXER_CASES = {
    "attn-gqa-bias": dict(qkv_bias=True),
    "attn-window": dict(window=5),
    "attn-mrope": dict(mrope_sections=(1, 1, 2)),
    "mla": dict(mixer_pattern=("mla",), kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8),
    "rglru": dict(mixer_pattern=("rglru",), d_rnn=24),
    "ssd": dict(mixer_pattern=("ssd",), d_state=6, ssd_head_dim=8,
                ssd_chunk=4),
}


@pytest.mark.parametrize("case", list(MIXER_CASES))
def test_mixer_forward_and_decode_match_the_reference(case):
    kw = {**MIXER_CFG, **MIXER_CASES[case]}
    ref_cfg, cfg = RefModelConfig(**kw), ModelConfig(**kw)
    mt = cfg.mixer_pattern[0]
    init, train, decode, cache_fn = rm.MIXERS[mt]
    p = init(jax.random.PRNGKey(1), ref_cfg)
    if mt == "rglru":        # non-zero gates, so every parameter counts
        rng = _rng(11)
        p = dict(p, **{k: jnp.asarray(_normal(rng, 24, scale=0.5))
                       for k in ("w_rgate", "b_rgate", "w_igate",
                                 "b_igate")})
    m = tm.MIXERS[mt](cfg)
    load_tree(m, jax.tree.map(np.asarray, p))
    make_compute_copies(m, torch.float32)
    rng = _rng(12)
    B, L = 2, 11
    x = _normal(rng, B, L, 32)
    pos = np.broadcast_to(np.arange(L), (B, L))
    if cfg.mrope_sections:
        pos = np.stack([pos, pos // 2, pos % 3], axis=-1)
    _close(m(_t(x), _t(pos)), train(p, jnp.asarray(x), jnp.asarray(pos),
                                    ref_cfg), case + " forward")

    cache = tm.MIXERS[mt].cache(cfg, B, 8, torch.float32, "cpu")
    rcache = cache_fn(ref_cfg, B, 8, jnp.float32)
    for t in range(L if cfg.window or mt in ("rglru", "ssd") else 8):
        y = m.decode(_t(x[:, t:t + 1]), cache, torch.tensor(t))
        ry, rcache = decode(p, jnp.asarray(x[:, t:t + 1]), rcache,
                            jnp.int32(t), ref_cfg)
        _close(y, ry, f"{case} decode {t}")
        for key in cache:
            _close(cache[key], rcache[key], f"{case} cache {key} {t}")


def test_mla_decode_is_the_absorbed_form_of_its_forward():
    """MLA's decode (latent-space attention) and forward (decompressed K
    and V) are different arithmetic for one function: on the same tokens
    they agree."""
    kw = {**MIXER_CFG, **MIXER_CASES["mla"]}
    cfg = ModelConfig(**kw)
    m = tm.MLA(cfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    x = _t(_normal(_rng(13), 2, 6, 32))
    full = m(x, torch.arange(6).expand(2, 6))
    cache = tm.MLA.cache(cfg, 2, 6, torch.float32, "cpu")
    for t in range(6):
        y = m.decode(x[:, t:t + 1], cache, torch.tensor(t))
        _close(y[:, 0], full[:, t].numpy(), f"step {t}")


def test_glorot_and_reset_use_the_reference_distributions():
    m = tm.SSD(ModelConfig(**{**MIXER_CFG, **MIXER_CASES["ssd"]}))
    m.reset_parameters(torch.Generator().manual_seed(0))
    p = rm.init_ssd(jax.random.PRNGKey(0), RefModelConfig(
        **{**MIXER_CFG, **MIXER_CASES["ssd"]}))
    for name in ("a_log", "dt_bias", "d_skip", "out_norm", "conv_b"):
        _close(getattr(m, name), p[name], name)   # fixed tables: equal
    w = tl.glorot((400, 600), torch.Generator().manual_seed(1))
    assert abs(float(w.std()) - np.sqrt(2.0 / 1000)) < 2e-3
