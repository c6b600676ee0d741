"""The four property sweeps of ``tests/test_properties.py`` on the port,
in the fast lane: the three GNN sweeps (bodies in
``test_torch_properties_cuda.py``, which runs them on the card) on the
CPU, where every kernel wrapper runs its plain version, and the
``flash_attention`` sweep on ragged lengths, against the naive softmax
and the reference's ``flash_attention`` on the same inputs.

Hypothesis example counts are the reference's (25, 20, 25, 10): the
port's CPU emulation runs an example in tens of milliseconds, so the
sweeps take a few seconds (the reference runs its three GNN sweeps only
in its ``slow`` lane, in Pallas interpret mode).  The sweeps are
derandomized, so every run and every test worker draws the same
examples."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import strategies as st  # noqa: E402

from repro.models.layers import flash_attention as ref_flash  # noqa: E402
from repro_torch.models.layers import flash_attention  # noqa: E402
from test_torch_properties_cuda import (  # noqa: E402
    COMPILED, SKIP, SPARSE, check_activation_skip_bit_identity,
    check_compiled_eager_pertask_bit_identity,
    check_sparse_kernels_match_dense, sweep)

CPU = torch.device("cpu")
FLASH_TOL = dict(rtol=5e-3, atol=5e-3)        # the reference's, vs naive
FLASH_REF_TOL = dict(rtol=1e-5, atol=1e-5)    # port vs reference, float32


@sweep(25, SPARSE)
def test_property_sparse_kernels_match_dense(nrb, ncb, nnb, da, dy, seed):
    check_sparse_kernels_match_dense(CPU, nrb, ncb, nnb, da, dy, seed)


@sweep(20, COMPILED)
def test_property_compiled_eager_pertask_bit_identity(M, K, N, tm, tn, dx,
                                                      dy, seed):
    check_compiled_eager_pertask_bit_identity(CPU, M, K, N, tm, tn, dx, dy,
                                              seed)


@sweep(25, SKIP)
def test_property_activation_skip_bit_identity(M, K, N, tm, tn, bd, dy, eps,
                                               dtype, capmode, seed):
    check_activation_skip_bit_identity(CPU, M, K, N, tm, tn, bd, dy, eps,
                                       dtype, capmode, seed)


def _naive_attention(q, k, v, causal=False):
    B, Lq, Hq, Dh = q.shape
    _, Lk, Hkv, _ = k.shape
    G = Hq // Hkv
    qf = q.astype(np.float32).reshape(B, Lq, Hkv, G, Dh)
    s = np.einsum("bqhgd,bkhd->bhgqk", qf, np.asarray(k, np.float32))
    s /= np.sqrt(Dh)
    if causal:
        mask = np.arange(Lk)[None, :] <= np.arange(Lq)[:, None]
        s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    out = np.einsum("bhgqk,bkhd->bqhgd", p, np.asarray(v, np.float32))
    return out.reshape(B, Lq, Hq, Dh)


@sweep(10, dict(lq=st.integers(1, 33), lk=st.integers(1, 33),
                seed=st.integers(0, 999)))
def test_property_flash_attention_ragged(lq, lk, seed):
    """flash == naive for arbitrary (non-chunk-aligned) lengths,
    cross-attention style; and == the reference's flash_attention."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, lq, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, lk, 2, 8)).astype(np.float32)
    v = rng.normal(size=(1, lk, 2, 8)).astype(np.float32)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal=False, q_chunk=8,
                          kv_chunk=8).numpy()
    np.testing.assert_allclose(got, _naive_attention(q, k, v), **FLASH_TOL)
    ref = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got, np.asarray(ref), **FLASH_REF_TOL)
