"""The port's LM training path against the JAX reference on the CPU, for
every architecture of ``ARCHS`` at ``reduce_config`` in float32: the
reference's parameters (``init(PRNGKey(0))``) carried over by
``params_from_jax``, then ``bundle.loss`` within rtol 1e-5, every
gradient within rtol 1e-4 and atol 1e-5 (the reference's gradient tree
is carried over by the same ``params_from_jax``, which refuses a missing
or an extra leaf), and one step of ``make_train_step`` (one microbatch):
the loss within rtol 1e-5, the gradient norm within rtol 1e-4, the
learning rate equal, the updated parameters within atol 1e-6 and both
moments within rtol 1e-4 / atol 1e-5 (one bfloat16 ulp for
deepseek-v2-236b's bfloat16 moments).  The reference's step for one
microbatch is ``jax.value_and_grad`` of its loss followed by
``adamw_update`` (``repro/launch/steps.py``); it is run as exactly that,
from the gradients already compared.  Also: a model whose bfloat16
compute copies were made trains exactly as one without, and a trained
model serves again through fresh copies.  The bfloat16 loss, two
microbatches and ``remat="full"`` are in ``test_torch_train_variants.py``,
which uses the helpers here."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.reduced import reduce_config as ref_reduce
from repro.launch import steps as ref_steps
from repro.models.registry import build_model as ref_build
from repro.optim import adamw as ref_adamw
from repro_torch.configs import ARCHS
from repro_torch.configs.reduced import reduce_config
from repro_torch.launch import steps
from repro_torch.models import encdec, lm
from repro_torch.models.layers import make_compute_copies, trainable
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig

ARCH_IDS = list(ARCHS)
CPU = torch.device("cpu")
B, L = 2, 16
LOSS_RTOL = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-5)
STEP_ATOL = 1e-6
OPT = AdamWConfig()          # the CLI's: lr 3e-4, 100 warm-up steps
# The first AdamW step moves each element by lr_1 g / (|g| + eps) (the
# moments start at zero), about lr_1 sign(g): an element whose gradient
# lies within the gradient tolerance of zero may take the other sign in
# one package and then moves up to 2 lr_1 = 6e-6 away.  Reduced
# recurrentgemma has such an element (a ``w_gate`` gradient of -1.2e-7 in
# the reference and 4.6e-8 in the port: the port's RG-LRU scan is
# sequential where the reference's is associative), so its step is held
# at 2 lr_1.
STEP_ATOL_BY_ARCH = {"recurrentgemma-9b": 2 * OPT.lr / OPT.warmup_steps}


def configs(arch, dtype="float32", **kw):
    """(port config, reference config), reduced, in ``dtype``."""
    cfg = dataclasses.replace(reduce_config(ARCHS[arch]), dtype=dtype, **kw)
    ref = dataclasses.replace(ref_reduce(REF_ARCHS[arch]), dtype=dtype, **kw)
    return cfg, ref


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's parameters (they do not depend on the dtype, the
    microbatches or remat)."""
    _, ref = configs(arch)
    return ref_build(ref).init(jax.random.PRNGKey(0))


def port_model(bundle, tree):
    """A port model holding a reference pytree (numpy leaves)."""
    return bundle.params_from_jax(jax.tree.map(np.asarray, tree), device=CPU)


def make_batch(cfg, seed=0, rows=B):
    """numpy inputs as tests/test_arch_smoke.py::_batch makes them: frames
    for the enc-dec arch, a frontend-stub prefix and M-RoPE positions for
    the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frames": rng.normal(size=(rows, L, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (rows, L))
                .astype(np.int32)}
    if cfg.frontend_prefix > 0:
        lp = int(L * cfg.frontend_prefix)
        pos = np.broadcast_to(np.arange(L)[None, :, None], (rows, L, 3))
        return {"embeds": rng.normal(size=(rows, lp, cfg.d_model))
                .astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (rows, L - lp))
                .astype(np.int32),
                "positions": pos.astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (rows, L)).astype(np.int32)}


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def assert_tree_close(bundle, got: dict, want_tree, tol, what):
    """``got`` (name -> tensor, None for a zero gradient) against a
    reference pytree carried over by ``params_from_jax`` (bfloat16 leaves
    widened to float32, exactly)."""
    want = dict(port_model(bundle, jax.tree.map(
        lambda a: np.asarray(a, np.float32), want_tree)).named_parameters())
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name] if got[name] is not None else torch.zeros_like(w)
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   w.detach().numpy(), **tol,
                                   err_msg=f"{what}: {name}")


def grads_of(model) -> dict:
    return {n: p.grad for n, p in model.named_parameters()}


def ref_value_and_grad(arch, **kw):
    """The reference's compiled loss and gradient tree on ``make_batch``."""
    _, ref = configs(arch, **kw)
    rb = ref_build(ref)
    batch = ref_batch(make_batch(ref))
    return jax.jit(jax.value_and_grad(rb.loss))(ref_params(arch), batch)


@functools.lru_cache(maxsize=None)
def ref_grads(arch):
    """``ref_value_and_grad`` of the reduced config, kept for the step."""
    return ref_value_and_grad(arch)


def ref_train_step(arch, mb):
    """The reference's state and metrics after one step from its
    parameters: with one microbatch its step's two calls on the gradients
    already computed, else its compiled ``make_train_step``."""
    _, ref = configs(arch, microbatches=mb)
    rp = ref_params(arch)
    opt = ref_adamw.adamw_init(rp, jnp.dtype(ref.opt_dtype))
    if mb == 1:
        loss, grads = ref_grads(arch)
        new_p, new_opt, metrics = jax.jit(
            ref_adamw.adamw_update, static_argnums=3)(
            grads, opt, rp, ref_adamw.AdamWConfig())
        return {"params": new_p, "opt": new_opt}, dict(metrics, loss=loss)
    return jax.jit(ref_steps.make_train_step(ref_build(ref),
                                             ref_adamw.AdamWConfig()))(
        {"params": rp, "opt": opt}, ref_batch(make_batch(ref)))


def check_train_step(arch, mb):
    """One step of the port and of the reference from the reference's
    parameters on ``make_batch``, held as the module docstring says."""
    cfg, _ = configs(arch, microbatches=mb)
    bundle = build_model(cfg)
    state = steps.train_state(bundle, port_model(bundle, ref_params(arch)))
    _, metrics = steps.make_train_step(bundle, OPT)(
        state, port_batch(make_batch(cfg)))
    want_state, want = ref_train_step(arch, mb)
    what = f"{arch} mb {mb}"
    np.testing.assert_allclose(metrics["loss"].item(), float(want["loss"]),
                               rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(want["grad_norm"]), rtol=GRAD["rtol"],
                               err_msg=what)
    assert metrics["lr"].item() == float(want["lr"])
    assert int(state["opt"]["step"]) == int(want_state["opt"]["step"]) == 1
    atol = STEP_ATOL_BY_ARCH.get(arch, STEP_ATOL)
    assert_tree_close(bundle, dict(state["params"].named_parameters()),
                      want_state["params"], dict(rtol=0, atol=atol),
                      f"{what} params")
    mtol = (dict(rtol=2 ** -7, atol=1e-7) if cfg.opt_dtype == "bfloat16"
            else GRAD)
    for key in ("mu", "nu"):
        got = state["opt"][key]
        assert {t.dtype for t in got.values()} == {
            getattr(torch, cfg.opt_dtype)}
        assert_tree_close(bundle, got, want_state["opt"][key], mtol,
                          f"{what} {key}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_the_reference_f32(arch):
    cfg, _ = configs(arch)
    bundle = build_model(cfg)
    assert bundle.loss is (encdec.lm_loss if cfg.n_enc_layers
                           else lm.lm_loss)
    model = trainable(port_model(bundle, ref_params(arch)))
    loss = bundle.loss(model, port_batch(make_batch(cfg)))
    assert loss.dtype == torch.float32 and loss.shape == ()
    loss.backward()
    want_loss, want_grads = ref_grads(arch)
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    assert_tree_close(bundle, grads_of(model), want_grads, GRAD, arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_the_reference_f32(arch):
    check_train_step(arch, mb=1)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-lite-16b"])
def test_compute_copies_do_not_reach_training(arch):
    """bfloat16 compute: a model whose bfloat16 weight copies were made
    (serving), once its parameters require grad, gives every parameter the
    gradient of a model without copies, bitwise, and two train steps keep
    the two equal (a copy would carry no gradient and go stale at the
    first update)."""
    cfg = reduce_config(ARCHS[arch])
    assert cfg.dtype == "bfloat16"
    bundle = build_model(cfg)
    served = port_model(bundle, ref_params(arch))        # copies made
    assert any(m._compute for m in served.modules() if hasattr(m, "_compute"))
    plain = port_model(bundle, ref_params(arch))
    for m in plain.modules():
        if hasattr(m, "_compute"):
            m._compute = {}
    batch = port_batch(make_batch(cfg))
    for model in (served, plain):
        model.requires_grad_(True)
        bundle.loss(model, batch).backward()
    for (name, a), (_, b) in zip(served.named_parameters(),
                                 plain.named_parameters()):
        assert b.grad is not None, name
        assert a.grad is not None and torch.equal(a.grad, b.grad), name

    served = port_model(bundle, ref_params(arch))
    make_compute_copies(served, torch.bfloat16)
    states = [steps.train_state(bundle, served),
              steps.train_state(bundle, plain)]
    assert not any(m._compute for m in served.modules()
                   if hasattr(m, "_compute"))
    step = steps.make_train_step(bundle, AdamWConfig(warmup_steps=0))
    for i in range(2):
        out = [step(s, port_batch(make_batch(cfg, seed=i, rows=4)))[1]
               for s in states]
        assert torch.equal(out[0]["loss"], out[1]["loss"])
    for (name, a), (_, b) in zip(states[0]["params"].named_parameters(),
                                 states[1]["params"].named_parameters()):
        assert torch.equal(a, b), name


def test_bundle_loss_is_the_lm_loss_of_the_padded_logits():
    """The loss takes the logsumexp over every padded-vocab column (the
    port's forward keeps them, as the reference's does), drops the
    frontend prefix and the last position, and equals a plain
    ``cross_entropy`` of the same logits."""
    cfg, _ = configs("qwen2-vl-72b")
    bundle = build_model(cfg)
    model = port_model(bundle, ref_params("qwen2-vl-72b"))
    batch = port_batch(make_batch(cfg))
    logits = bundle.forward(model, batch)
    assert logits.shape[-1] == cfg.padded_vocab
    n_prefix = batch["embeds"].shape[1]
    want = torch.nn.functional.cross_entropy(
        logits[:, n_prefix:-1].reshape(-1, cfg.padded_vocab),
        batch["tokens"][:, 1:].reshape(-1).long())
    torch.testing.assert_close(bundle.loss(model, batch), want, rtol=1e-6,
                               atol=1e-6)


def test_a_trained_model_serves_again_through_its_copies():
    """``trainable`` then ``make_compute_copies``: grads off again, fresh
    bfloat16 copies of the trained parameters, and the served forward
    equals that of a model loaded with the same parameters."""
    cfg = reduce_config(ARCHS["qwen2.5-3b"])
    bundle = build_model(cfg)
    state = steps.train_state(bundle, port_model(bundle, ref_params(
        "qwen2.5-3b")))
    steps.make_train_step(bundle, AdamWConfig(warmup_steps=0))(
        state, port_batch(make_batch(cfg, rows=4)))
    model = state["params"]
    make_compute_copies(model, torch.bfloat16)
    assert not any(p.requires_grad for p in model.parameters())
    fresh = build_model(cfg).init(1, "cpu")
    fresh.load_state_dict(model.state_dict())
    make_compute_copies(fresh, torch.bfloat16)
    batch = port_batch(make_batch(cfg))
    with torch.no_grad():
        assert torch.equal(bundle.forward(model, batch),
                           bundle.forward(fresh, batch))
