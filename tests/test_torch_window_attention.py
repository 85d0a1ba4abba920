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
    check_kernel_shapes, window_attention, window_attention_plain)

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


def test_kernel_shape_checks():
    """The kernel's own limits at the read's shape, without a card: the
    tower's packed qkv (16 heads of 80, window 64) and the fp32 reference
    tower (2 heads of 80) are accepted; shapes the kernel cannot take are
    refused."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    vis = VLConfig().vision
    plan = plan_grid(vis, (1, 924 // 14, 672 // 14))
    shape = (8, len(plan.valid), 3 * vis.hidden_size)
    check_kernel_shapes(shape, torch.bfloat16, num_heads=vis.num_heads,
                        window_len=plan.window_len)
    check_kernel_shapes((4, 192, 480), torch.float32, num_heads=2,
                        window_len=64)
    for shape, dtype, heads, window_len in (
            ((8, 3456, 3840), torch.bfloat16, 16, 16),    # window 16
            ((8, 3456, 3840), torch.bfloat16, 20, 64),    # head dim 64
            ((8, 3456, 720), torch.bfloat16, 3, 64),      # odd head count
            ((8, 3456, 3840), torch.float16, 16, 64)):    # dtype
        with pytest.raises(ValueError):
            check_kernel_shapes(shape, dtype, num_heads=heads,
                                window_len=window_len)


def _tf32(x):
    """x cut to tf32 (its 13 low mantissa bits cleared), as the fp32
    body's ``split_tf32`` cuts each part (``csrc/hopper.cuh``)."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b as the fp32 body's tensor cores take it: one TF32 pass, or
    3xTF32 (each operand split into tf32 hi + lo = tf32(x - hi), lo.hi +
    hi.lo + hi.hi, every product exact and summed in fp32)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


@pytest.mark.parametrize("passes,passes_bound", [(3, True), (1, False)])
def test_3xtf32_meets_the_fp32_bound(passes, passes_bound):
    """The numerics of the 3xTF32 fp32 body, emulated on the CPU at the
    tower's head width: the plain version with both products (Q.K^T and
    P.V) taken as the body takes them. 3xTF32 stays within the fp32 bound
    the card holds the body to (``chip_smoke.py:_compare(fp32=True)``:
    2^-14 of the peak, 1e-5 RMS); one TF32 pass does not."""
    from handwritten_ocr_tpu_torch.ops.window_attention import _rope
    rng = np.random.default_rng(5)
    b, n_win, wl, heads, hd = 1, 3, 64, 2, 80
    p, d = n_win * wl, heads * hd
    qkv = torch.from_numpy(rng.standard_normal((b, p, 3 * d), dtype=np.float32))
    cos = torch.from_numpy(np.cos(rng.standard_normal((p, hd))).astype(np.float32))
    sin = torch.from_numpy(np.sin(rng.standard_normal((p, hd))).astype(np.float32))
    valid = torch.ones(p, dtype=torch.bool)
    valid[[3, 70, 100, 101]] = False
    scale = hd ** -0.5
    want = window_attention_plain(qkv, cos, sin, valid, num_heads=heads,
                                  window_len=wl, scale=scale)

    def windows(x):
        return x.reshape(b, n_win, wl, heads, hd).transpose(2, 3)

    q, k, v = (x.reshape(b, p, heads, hd) for x in qkv.split(d, dim=-1))
    q, k = (_rope(x, cos[None, :, None], sin[None, :, None]) for x in (q, k))
    s = _tf32_product(windows(q), windows(k).transpose(-1, -2), passes) * scale
    s = s.masked_fill(~valid.reshape(1, n_win, 1, 1, wl), float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    got = _tf32_product(e / e.sum(dim=-1, keepdim=True), windows(v), passes)
    got = got.transpose(2, 3).reshape(b, p, d)
    diff = got - want
    within = (float(diff.abs().max()) <= 2.0 ** -14 * float(want.abs().max())
              and float(diff.pow(2).mean().sqrt())
              <= 1e-5 * float(want.pow(2).mean().sqrt()))
    assert within == passes_bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,heads,batch", [
    (torch.float32, 2, 1), (torch.float32, 2, 2), (torch.float32, 16, 1),
    (torch.float32, 16, 2), (torch.bfloat16, 16, 2)])
def test_kernel_matches_plain_on_cuda(dtype, heads, batch):
    """Kernel against its plain version on the card at the tower's head
    width (80, window 64), with a partly dead window, dead slots
    scattered through others and one wholly dead window, whose output
    must be exactly 0. fp32 (the 3xTF32 body), at the reference towers'
    2 heads and the tower's 16, batch 1 and 2: 1e-4 and the fp32 bound
    (``assert_fp32_close``: 2^-14 of the peak, 1e-5 RMS), which a single
    TF32 pass fails. bf16 (16 heads, batch 2): 2e-2 absolute (both round
    rope, P and the output to bf16 at the same points, so only the
    summation order differs), and the RMS of the error within 1% of the
    RMS of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_flash_attention import assert_fp32_close
    rng = np.random.default_rng(1)
    p, hd = 6 * 64, 80
    qkv = torch.from_numpy(rng.standard_normal((batch, p, 3 * heads * hd),
                                               dtype=np.float32))
    cos = torch.from_numpy(np.cos(rng.standard_normal((p, hd))).astype(np.float32))
    sin = torch.from_numpy(np.sin(rng.standard_normal((p, hd))).astype(np.float32))
    valid = torch.ones(p, dtype=torch.bool)
    valid[100:128] = False
    valid[[5, 17, 40, 63, 300, 301, 350]] = False
    valid[192:256] = False                       # window 3: every slot dead
    args = (qkv.to("cuda", dtype), cos.cuda(), sin.cuda(), valid.cuda())
    kw = dict(num_heads=heads, window_len=64, scale=hd ** -0.5)
    got = window_attention(*args, **kw).float()
    want = window_attention_plain(*args, **kw).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rel_rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert rel_rms <= 1e-2
    if dtype == torch.float32:
        assert_fp32_close(got, want)
    assert bool((got[:, 192:256] == 0).all())
