"""The port's optimizer and gradient compression against the reference on
the CPU: ``adamw_update`` on a small tree within 1e-7 relative (also with
bfloat16 moments, and with a None gradient taken as a zero one) over
several steps of the schedule; ``compress_decompress`` bitwise; and the
ports of ``tests/test_distributed.py``'s two compression tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.optim import adamw
from repro_torch.optim.compression import compress_decompress, ef_init

SHAPES = {"embed": (16, 8), "w": (8, 12), "bias": (12,), "norm": (8,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _port(tree, dtype=torch.float32):
    return {n: torch.tensor(a, dtype=dtype) for n, a in tree.items()}


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    dict(), dict(warmup_steps=2, total_steps=5, lr=1e-2),
    dict(warmup_steps=0, total_steps=3, grad_clip=0.5, weight_decay=0.0)])
def test_adamw_matches_the_reference(cfg, moments, clipped):
    """Five steps (past warm-up and, for short schedules, past the end of
    the cosine), with gradients of norm below the clip (parameters within
    1e-7 relative), or (``clipped``) above it on every other step: the
    global norm's summation order (``torch.sum`` against XLA's reduce)
    can move the clip scale by one ulp, and a clipped step then holds
    within 1e-6 relative."""
    rtol = 1e-6 if clipped else 1e-7
    ref_cfg = ref_adamw.AdamWConfig(**cfg)
    port_cfg = adamw.AdamWConfig(**cfg)
    p0 = _tree(0)
    rp = {n: jnp.asarray(a) for n, a in p0.items()}
    ropt = ref_adamw.adamw_init(rp, jnp.dtype(moments))
    params = _port(p0)
    opt = adamw.adamw_init(params, getattr(torch, moments))
    for step in range(5):
        g = _tree(10 + step, scale=0.3 if clipped and step % 2 else 0.01)
        rp, ropt, rm = ref_adamw.adamw_update(
            {n: jnp.asarray(a) for n, a in g.items()}, ropt, rp, ref_cfg)
        m = adamw.adamw_update(_port(g), opt, params, port_cfg)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(m["lr"].item(), float(rm["lr"]),
                                   rtol=1e-7)
        assert int(opt["step"]) == int(ropt["step"]) == step + 1
        for n in SHAPES:
            np.testing.assert_allclose(params[n].numpy(), np.asarray(rp[n]),
                                       rtol=rtol, atol=0, err_msg=n)
            for key in ("mu", "nu"):
                got, want = opt[key][n], ropt[key][n]
                assert got.dtype == getattr(torch, moments)
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=rtol if moments == "float32" else 2 ** -8,
                    atol=1e-9 if clipped else 0, err_msg=f"{key} {n}")


def test_adamw_takes_a_none_gradient_as_zero():
    """A parameter with no gradient still decays (weight decay, and its
    moments by b1 / b2), as the reference's zero leaf does."""
    p0 = _tree(1)
    g = _tree(2)
    params = _port(p0)
    opt = adamw.adamw_init(params)
    rp = {n: jnp.asarray(a) for n, a in p0.items()}
    ropt = ref_adamw.adamw_init(rp)
    cfg = dict(warmup_steps=0, total_steps=4)
    for _ in range(2):
        grads = _port(g) | {"norm": None}
        m = adamw.adamw_update(grads, opt, params, adamw.AdamWConfig(**cfg))
        rg = {n: jnp.asarray(a) for n, a in g.items()} | {
            "norm": jnp.zeros(SHAPES["norm"])}
        rp, ropt, rm = ref_adamw.adamw_update(rg, ropt, rp,
                                              ref_adamw.AdamWConfig(**cfg))
    np.testing.assert_allclose(m["grad_norm"].item(), float(rm["grad_norm"]),
                               rtol=1e-6)
    assert not torch.equal(params["norm"], torch.as_tensor(p0["norm"]))
    for n in SHAPES:
        np.testing.assert_allclose(params[n].numpy(), np.asarray(rp[n]),
                                   rtol=1e-7, err_msg=n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_is_bitwise_the_reference(seed):
    """Three rounds of error feedback: every dequantized gradient and every
    residual equal bitwise (``torch.round`` and ``jnp.round`` both round
    half to even; a leaf of halves checks that)."""
    g = _tree(seed)
    g["halves"] = (np.arange(-8, 9, dtype=np.float32) + 0.5) * (8 / 127)
    ref_ef = ref_comp.ef_init({n: jnp.asarray(a) for n, a in g.items()})
    ef = ef_init(_port(g))
    for r in range(3):
        grads = {n: a * (r + 1) for n, a in g.items()}
        want, ref_ef = ref_comp.compress_decompress(
            {n: jnp.asarray(a) for n, a in grads.items()}, ref_ef)
        got, ef = compress_decompress(_port(grads), ef)
        for n in g:
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
            np.testing.assert_array_equal(ef[n].numpy(),
                                          np.asarray(ref_ef[n]))


def test_compression_error_feedback_converges():
    """Port of ``tests/test_distributed.py::
    test_compression_error_feedback_converges``: int8 + EF gradient descent
    reaches the float32 optimum of a quadratic."""
    w_true = np.array([1.5, -2.0, 0.5], np.float32)

    def grad(w, rng):
        x = rng.normal(size=(32, 3)).astype(np.float32)
        return ((x @ (w - w_true))[:, None] * x).mean(0) * 2

    rng = np.random.default_rng(0)
    w_fp = torch.zeros(3)
    w_q = torch.zeros(3)
    ef = ef_init({"g": w_q})
    for _ in range(300):
        w_fp = w_fp - 0.05 * torch.as_tensor(grad(w_fp.numpy(), rng))
        g2 = torch.as_tensor(grad(w_q.numpy(), rng))
        gq, ef = compress_decompress({"g": g2}, ef)
        w_q = w_q - 0.05 * gq["g"]
    np.testing.assert_allclose(w_q.numpy(), w_true, atol=0.1)
    np.testing.assert_allclose(w_fp.numpy(), w_true, atol=0.1)


def test_compression_quantization_bounded():
    """Port of ``tests/test_distributed.py::
    test_compression_quantization_bounded``: the error is at most half a
    quantization step and the EF state holds exactly the residual."""
    g = {"a": torch.as_tensor(np.random.default_rng(1).normal(size=(64,))
                              .astype(np.float32))}
    deq, ef2 = compress_decompress(g, ef_init(g))
    err = (deq["a"] - g["a"]).abs()
    scale = g["a"].abs().max().item() / 127.0
    assert err.max().item() <= scale * 0.51 + 1e-7
    torch.testing.assert_close(ef2["a"], g["a"] - deq["a"], rtol=0,
                               atol=1e-6)


def test_compression_takes_a_none_gradient_as_zero():
    """A leaf without a gradient passes its error-feedback residual on."""
    ef = {"a": torch.tensor([0.5, -0.25, 0.0]), "b": torch.zeros(2)}
    out, ef2 = compress_decompress({"a": None, "b": torch.ones(2)}, ef)
    want, ref_ef = ref_comp.compress_decompress(
        {"a": jnp.zeros(3), "b": jnp.ones(2)},
        {k: jnp.asarray(v.numpy()) for k, v in ef.items()})
    for k in ef:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(ef2[k].numpy(), np.asarray(ref_ef[k]))
