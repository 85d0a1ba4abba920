"""Each function of the port's ``models/layers.py`` against the JAX package.

Inputs from numpy with a seed. fp32: 1e-5 (same math, another kernel
library). bf16: both sides round at the same op boundaries, but a matmul
may round its sum once (PyTorch) or per partial block (XLA), so the bound
is a few bf16 ulps of unit-scale values: 3e-2 absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_ocr_tpu.models import layers as jl
from handwritten_ocr_tpu_torch.models import layers as tl

torch.set_num_threads(1)

DTYPES = [("float32", 1e-5), ("bfloat16", 3e-2)]


def pair(array, dtype):
    """The same values as a JAX and a torch array of ``dtype``."""
    jax_x = jnp.asarray(array, dtype=getattr(jnp, dtype))
    torch_x = torch.from_numpy(np.array(jax_x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jax_x, torch_x


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def linear_pair(rng, d_in, d_out, dtype, bias=True):
    w = rng.normal(0, 0.2, (d_in, d_out))
    jw, tw = pair(w, dtype)
    jp, tp = {"w": jw}, {"w": tw.t().contiguous()}
    if bias:
        jb, tb = pair(rng.normal(0, 0.1, d_out), dtype)
        jp["b"], tp["b"] = jb, tb
    return jp, tp


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(0)
    jx, tx = pair(rng.normal(0, 2, (3, 5, 16)), dtype)
    js, ts = pair(rng.normal(1, 0.1, 16), dtype)
    close(tl.rms_norm({"scale": ts}, tx, 1e-6),
          jl.rms_norm({"scale": js}, jx, 1e-6), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_linear_and_mlps(dtype, tol):
    rng = np.random.default_rng(1)
    jx, tx = pair(rng.normal(0, 1, (2, 7, 16)), dtype)
    jp, tp = linear_pair(rng, 16, 24, dtype)
    close(tl.linear(tp, tx), jl.linear(jp, jx), tol)
    jm, tm = {}, {}
    for name, shape in (("gate", (16, 32)), ("up", (16, 32)),
                        ("down", (32, 16))):
        jm[name], tm[name] = linear_pair(rng, *shape, dtype)
    close(tl.swiglu_mlp(tm, tx), jl.swiglu_mlp(jm, jx), tol)
    jg, tg = {}, {}
    for name, shape in (("fc1", (16, 32)), ("fc2", (32, 8))):
        jg[name], tg[name] = linear_pair(rng, *shape, dtype)
    close(tl.gelu_mlp(tg, tx), jl.gelu_mlp(jg, jx), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rotate_half_and_apply_rope(dtype, tol):
    rng = np.random.default_rng(2)
    jq, tq = pair(rng.normal(0, 1, (2, 6, 4, 8)), dtype)
    jk, tk = pair(rng.normal(0, 1, (2, 6, 2, 8)), dtype)
    angles = rng.normal(0, 3, (1, 6, 1, 8))
    jc, tc = pair(np.cos(angles), "float32")
    js, ts = pair(np.sin(angles), "float32")
    close(tl.rotate_half(tq), jl.rotate_half(jq), 0)
    got_q, got_k = tl.apply_rope(tq, tk, tc, ts)
    want_q, want_k = jl.apply_rope(jq, jk, jc, js)
    assert got_q.dtype == tq.dtype and got_k.dtype == tk.dtype
    close(got_q, want_q, tol)
    close(got_k, want_k, tol)


def test_rope_inv_freq():
    np.testing.assert_allclose(tl.rope_inv_freq(16, 10000.0).numpy(),
                               np.asarray(jl.rope_inv_freq(16, 10000.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_gqa_attention_with_mask(dtype, tol):
    rng = np.random.default_rng(3)
    jq, tq = pair(rng.normal(0, 1, (2, 5, 6, 8)), dtype)
    jk, tk = pair(rng.normal(0, 1, (2, 7, 2, 8)), dtype)
    jv, tv = pair(rng.normal(0, 1, (2, 7, 2, 8)), dtype)
    mask = rng.random((2, 1, 5, 7)) > 0.3
    mask[0, 0, 2] = False                     # an all-masked row
    got = tl.attention(tq, tk, tv, torch.from_numpy(mask), 8 ** -0.5)
    want = jl.attention(jq, jk, jv, jnp.asarray(mask), 8 ** -0.5)
    close(got, want, tol)
    close(tl.attention(tq, tk, tv, None, 0.3),
          jl.attention(jq, jk, jv, None, 0.3), tol)
