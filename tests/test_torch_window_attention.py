"""Window attention of the PyTorch port against the JAX Pallas kernel.

The JAX kernel (packed layout, the default) runs through the Pallas
interpreter; the port's CPU path is its plain version. fp32 on both
sides: 2e-5. Dead slots are compared too, and a wholly dead window must
give exactly 0 on both sides. JAX is imported inside the parity tests,
so the CUDA case also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.ops.window_attention import (
    window_attention, window_attention_plain)

TOL = dict(rtol=2e-5, atol=2e-5)
HEADS, HD = 4, 16


def make(b, n_win, window_len, seed=0):
    rng = np.random.default_rng(seed)
    p = n_win * window_len
    qkv = rng.standard_normal((b, p, 3 * HEADS * HD)).astype(np.float32)
    cos = np.cos(rng.standard_normal((p, HD))).astype(np.float32)
    sin = np.sin(rng.standard_normal((p, HD))).astype(np.float32)
    valid = np.ones(p, bool)
    valid[window_len - 3:window_len] = False          # ragged edge window
    valid[2 * window_len:3 * window_len] = False      # a wholly dead window
    return qkv, cos, sin, valid


def port(qkv, cos, sin, valid, window_len, fn=window_attention):
    return fn(torch.from_numpy(qkv), torch.from_numpy(cos),
              torch.from_numpy(sin), torch.from_numpy(valid),
              num_heads=HEADS, window_len=window_len,
              scale=HD ** -0.5).numpy()


@pytest.mark.parametrize("n_win,window_len", [(4, 16), (3, 64)])
def test_matches_jax_kernel(n_win, window_len):
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.window_attention import (
        window_attention as jax_window)
    qkv, cos, sin, valid = make(2, n_win, window_len, seed=window_len)
    want = np.asarray(jax_window(
        jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(valid), num_heads=HEADS, window_len=window_len,
        scale=HD ** -0.5, interpret=True, packed=True))
    got = port(qkv, cos, sin, valid, window_len)
    np.testing.assert_allclose(got, want, **TOL)
    dead = slice(2 * window_len, 3 * window_len)
    assert np.all(got[:, dead] == 0.0) and np.all(want[:, dead] == 0.0)


def test_plain_matches_jax_reference():
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.window_attention import _window_reference
    qkv, cos, sin, valid = make(1, 4, 16, seed=9)
    want = np.asarray(_window_reference(
        jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(valid.astype(np.float32)), HEADS, 16, HD ** -0.5))
    got = port(qkv, cos, sin, valid, 16, fn=window_attention_plain)
    np.testing.assert_allclose(got, want, **TOL)


def test_rejects_bad_tables():
    qkv, cos, sin, valid = make(1, 2, 16)
    with pytest.raises(ValueError):
        port(qkv, cos[:-1], sin, valid, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(dtype):
    """Kernel against its plain version on the card at the tower's head
    width (16 heads of 80, window 64). fp32: 1e-4; bf16: 2e-2 absolute
    (both round rope, P and the output to bf16 at the same points, so only
    the summation order and FMA contraction differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    p, heads, hd = 6 * 64, 16, 80
    qkv = torch.from_numpy(rng.standard_normal((2, p, 3 * heads * hd),
                                               dtype=np.float32))
    cos = torch.from_numpy(np.cos(rng.standard_normal((p, hd))).astype(np.float32))
    sin = torch.from_numpy(np.sin(rng.standard_normal((p, hd))).astype(np.float32))
    valid = torch.ones(p, dtype=torch.bool)
    valid[100:128] = False
    args = (qkv.to("cuda", dtype), cos.cuda(), sin.cuda(), valid.cuda())
    kw = dict(num_heads=heads, window_len=64, scale=hd ** -0.5)
    got = window_attention(*args, **kw).float()
    want = window_attention_plain(*args, **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
