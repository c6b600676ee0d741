"""The port's flash attention with the recompute-based custom backward
(``layers.flash_attention_vjp``, the ``_FlashCore`` autograd function)
against the reference's ``flash_attention_vjp`` (its ``jax.custom_vjp``)
and against autograd through the port's own ``flash_attention``, on the
CPU in float32 within 1e-5: the forward and dq, dk, dv of a weighted sum
of the output, for GQA, causal, ``causal_skip``, a local window, a kv
length mask and ragged lengths (chunks of 8 that do not divide L); the
ports of ``tests/test_layers.py``'s two flash-VJP tests; and the
mixers' choice of the VJP by ``cfg.flash_vjp``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention_vjp as ref_flash_vjp
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.models import layers
from repro_torch.models.layers import flash_attention, flash_attention_vjp
from repro_torch.models.registry import build_model

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Lq, Lk, Hq, Hkv, Dh, keyword arguments)
CASES = {
    "gqa-causal": (1, 36, 36, 4, 2, 8, dict(causal=True)),
    "causal-skip": (1, 32, 32, 2, 2, 8, dict(causal=True, causal_skip=True)),
    "ragged-skip": (2, 27, 27, 4, 1, 8, dict(causal=True, causal_skip=True)),
    "window": (1, 40, 40, 4, 2, 8, dict(causal=True, window=11)),
    "bidirectional-ragged": (2, 21, 30, 6, 3, 8, dict(causal=False)),
    "kv-len-mask": (1, 16, 24, 4, 2, 8, dict(causal=False, kv_len_mask=19)),
    "q-offset": (1, 12, 28, 4, 4, 8, dict(causal=True, q_offset=16)),
}


def _inputs(b, lq, lk, hq, hkv, dh, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, lq, hq, dh), (b, lk, hkv, dh), (b, lk, hkv, dh),
                      (b, lq, hq, dh))]


def _port_grads(fn, q, k, v, w, kw):
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts, q_chunk=8, kv_chunk=8, **kw)
    (out * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", list(CASES))
def test_flash_vjp_matches_the_reference_and_autograd(case):
    b, lq, lk, hq, hkv, dh, kw = CASES[case]
    q, k, v, w = _inputs(b, lq, lk, hq, hkv, dh)

    def ref_loss(q, k, v):
        out = ref_flash_vjp(q, k, v, q_chunk=8, kv_chunk=8, **kw)
        return jnp.sum(out * w), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    out, grads = _port_grads(flash_attention_vjp, q, k, v, w, kw)
    auto_out, auto_grads = _port_grads(flash_attention, q, k, v, w, kw)
    np.testing.assert_array_equal(out, auto_out)      # the same forward
    np.testing.assert_allclose(out, np.asarray(ref_out), **TOL)
    for name, g, r, a in zip("qkv", grads, ref_grads, auto_grads):
        np.testing.assert_allclose(g, np.asarray(r), **TOL,
                                   err_msg=f"d{name} vs the reference")
        np.testing.assert_allclose(g, a, **TOL,
                                   err_msg=f"d{name} vs autograd")


def test_flash_vjp_forward_and_grads_match_naive():
    """Port of ``tests/test_layers.py::
    test_flash_vjp_forward_and_grads_match_naive`` at its shapes and
    tolerances: the VJP's forward and gradients against a plain
    differentiable softmax attention."""
    B, L, Hq, Hkv, Dh = 1, 36, 4, 2, 8
    q, k, v, w = _inputs(B, L, L, Hq, Hkv, Dh)

    def naive(q, k, v):
        G = Hq // Hkv
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, L, Hkv, G, Dh),
                         k) / np.sqrt(Dh)
        mask = torch.tril(torch.ones((L, L), dtype=torch.bool))
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, L, Hq, Dh)

    def run(fn):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        f = (fn(*ts) * torch.as_tensor(w)).sum()
        f.backward()
        return f.item(), [t.grad for t in ts]

    f0, g0 = run(naive)
    f1, g1 = run(lambda q, k, v: flash_attention_vjp(
        q, k, v, causal=True, q_chunk=8, kv_chunk=8))
    assert abs(f0 - f1) < 1e-2
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)


def test_flash_vjp_causal_skip_grads():
    """Port of ``tests/test_layers.py::test_flash_vjp_causal_skip_grads``:
    gradients with ``causal_skip`` equal those without (atol 1e-4)."""
    q, k, v, _ = _inputs(1, 32, 32, 2, 2, 8, seed=6)

    def grads(skip):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = flash_attention_vjp(*ts, causal=True, q_chunk=8, kv_chunk=8,
                                  causal_skip=skip)
        (out ** 2).sum().backward()
        return [t.grad for t in ts]

    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_flash_vjp_saves_no_block_probabilities():
    """What the backward keeps: the VJP saves (q, k, v, out, lse), where
    autograd through ``flash_attention`` saves tensors of every block pair
    (on the card this is peak memory; here the saved bytes are counted)."""
    q, k, v, _ = _inputs(1, 64, 64, 4, 2, 8)

    def saved_bytes(fn):
        total = []

        def pack(t):
            total.append(t.numel() * t.element_size())
            return t

        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(*ts, causal=True, q_chunk=8, kv_chunk=8)
        return sum(total)

    vjp, auto = saved_bytes(flash_attention_vjp), saved_bytes(flash_attention)
    io = 4 * (3 * 64 * 4 * 8 + 64 * 4)      # q, out, lse (+ k, v below)
    assert vjp <= io + 4 * 2 * 64 * 2 * 8
    assert auto > 10 * vjp


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_mixers_take_the_vjp_when_the_config_asks(arch, monkeypatch):
    """GQA attention and MLA call ``flash_attention_vjp`` exactly when
    ``cfg.flash_vjp`` is set, and the loss and gradients agree."""
    calls = []
    real = layers._FlashCore.apply

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(layers._FlashCore, "apply", counting)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 12)))
    out = {}
    for vjp in (False, True):
        cfg = dataclasses.replace(reduce_config(ARCHS[arch]),
                                  dtype="float32", flash_vjp=vjp)
        bundle = build_model(cfg)
        model = layers.trainable(bundle.init(0, "cpu"))
        calls.clear()
        loss = bundle.loss(model, {"tokens": toks})
        loss.backward()
        assert len(calls) == (cfg.n_layers if vjp else 0)
        out[vjp] = (loss, {n: p.grad for n, p in model.named_parameters()})
    torch.testing.assert_close(out[True][0], out[False][0], **TOL)
    for name, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][name], g, **TOL, msg=name)
