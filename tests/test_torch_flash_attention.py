"""Flash attention of the PyTorch port against the JAX Pallas kernel.

The JAX kernel runs through the Pallas interpreter on the CPU; the port's
CPU path is its plain version. Inputs come from numpy with a seed.
Tolerance: fp32 on both sides, the same algorithm in another summation
order, so 2e-5 absolute and relative. JAX is imported inside the parity
tests, so the CUDA case also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.ops.flash_attention import (
    check_kernel_shapes, flash_attention, flash_attention_plain)

TOL = dict(rtol=2e-5, atol=2e-5)


def make(b, t, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def run_both(q, k, v, mask, causal):
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.flash_attention import (
        flash_attention as jax_flash)
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal=causal,
        block_q=64, block_k=64, interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          None if mask is None else torch.from_numpy(mask),
                          causal=causal).numpy()
    return got, want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)])
def test_matches_jax_kernel(causal, hq, hkv):
    q, k, v = make(2, 96, 96, hq, hkv, 32, seed=hq)
    got, want = run_both(q, k, v, None, causal)
    np.testing.assert_allclose(got, want, **TOL)


def test_ragged_length_and_shared_mask():
    q, k, v = make(1, 70, 70, 2, 1, 32, seed=3)
    mask = np.ones(70, bool)
    mask[[3, 40, 41, 69]] = False
    got, want = run_both(q, k, v, mask, False)
    np.testing.assert_allclose(got, want, **TOL)


def test_per_row_mask_and_all_masked_row_gives_zero():
    q, k, v = make(2, 64, 64, 4, 2, 32, seed=4)
    mask = np.ones((2, 64), bool)
    mask[0, 10:] = False
    mask[1] = False                      # row 1: every key masked
    got, want = run_both(q, k, v, mask, False)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1] == 0.0)


def test_plain_matches_jax_reference_attention():
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.flash_attention import _reference_attention
    q, k, v = make(1, 50, 50, 4, 2, 16, seed=5)
    mask = np.ones((1, 50), np.float32)
    mask[0, 7] = 0
    want = np.asarray(_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        True, 0.25))
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(mask),
                                causal=True, scale=0.25).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rejects_bad_shapes():
    q, k, v = make(1, 8, 8, 4, 3, 16)
    with pytest.raises(ValueError):
        flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v))


def test_kernel_shape_checks():
    """The kernel's own limits at the two paths' shapes, without a card:
    every shape the read and the reasoner launch is accepted (the vision
    global layers with a key mask, both causal prefills, the fp32
    reference models), and shapes the kernel cannot take are refused."""
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.vision import plan_grid
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    cfg, qcfg = VLConfig(), Qwen3Config()
    vis, txt = cfg.vision, cfg.text
    p = len(plan_grid(vis, (1, 924 // 14, 672 // 14)).valid)
    accepted = [
        ((8, p, vis.num_heads, vis.head_dim), (8, p, vis.num_heads, vis.head_dim),
         torch.bfloat16, False),
        ((8, 1024, txt.num_attention_heads, txt.head_dim),
         (8, 1024, txt.num_key_value_heads, txt.head_dim), torch.bfloat16, True),
        ((8, 1280, qcfg.num_attention_heads, qcfg.head_dim),
         (8, 1280, qcfg.num_key_value_heads, qcfg.head_dim), torch.bfloat16, True),
        ((4, 48, 2, 80), (4, 48, 2, 80), torch.float32, False),
        ((2, 40, 2, 128), (2, 40, 1, 128), torch.float32, True),
    ]
    for q_shape, kv_shape, dtype, causal in accepted:
        check_kernel_shapes(q_shape, kv_shape, dtype, causal=causal)
    refused = [
        ((8, 256, 16, 64), (8, 256, 16, 64), torch.bfloat16, False),
        ((8, 256, 16, 96), (8, 256, 16, 96), torch.bfloat16, False),
        ((8, 256, 16, 128), (8, 256, 16, 128), torch.float16, False),
        ((8, 256, 16, 128), (8, 300, 16, 128), torch.bfloat16, True),
        ((2048, 64, 64, 128), (2048, 64, 8, 128), torch.bfloat16, True),
    ]
    for q_shape, kv_shape, dtype, causal in refused:
        with pytest.raises(ValueError):
            check_kernel_shapes(q_shape, kv_shape, dtype, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("mask_rows", [0, 1, 2])
@pytest.mark.parametrize("t,hq,hkv", [(200, 8, 2), (200, 8, 8), (1024, 28, 4),
                                      (1280, 64, 8)])
def test_kernel_matches_plain_on_cuda(dtype, causal, d, mask_rows, t, hq, hkv):
    """Kernel against its plain version on the card, at both head widths
    (vision 80, text 128; bf16 takes the wgmma body), at a ragged length
    (200) and at whole 128-row q tiles (1024, 1280), GQA groups 4, 1, 7
    and 8, with no key mask (only the ragged tile and the causal diagonal
    are masked elementwise), an [S] or a [B, S] mask. Key 3 and 77 are
    masked and so is the whole second 128-key tile; with a [B, S] mask
    batch 1 has every key masked, so its output must be exactly 0. fp32:
    1e-4 (fp32 FMA in another order). bf16: 2e-2 absolute and relative elementwise
    (one bf16 rounding of the output, P rounded to bf16 against another
    running max), and the RMS of the error within 1% of the RMS of the
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = make(2, t, t, hq, hkv, d, seed=6)
    mask = np.ones((max(mask_rows, 1), t), bool)
    mask[0, [3, 77]] = False
    mask[0, 128:256] = False
    if mask_rows == 2:
        mask[1] = False
    args = [torch.from_numpy(x).to("cuda", dtype) for x in (q, k, v)]
    m = (None if mask_rows == 0 else
         torch.from_numpy(mask[0] if mask_rows == 1 else mask).cuda())
    got = flash_attention(*args, m, causal=causal).float()
    want = flash_attention_plain(*args, m, causal=causal).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rel_rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert rel_rms <= 1e-2
    if dtype == torch.float32:
        assert_fp32_close(got, want)
    if mask_rows == 2:
        assert bool((got[1] == 0).all())


def assert_fp32_close(got, want):
    """fp32 output against the plain version at ``chip_smoke.py``'s fp32
    bound: the largest error within 2^-14 of max|want|, the RMS error
    within 1e-5 of RMS(want) (two fp32 sums in another order, exp2 for
    exp; a TF32 product, ~5e-4, fails it)."""
    diff = got - want
    assert float(diff.abs().max()) <= 2.0 ** -14 * float(want.abs().max())
    assert float(diff.pow(2).mean().sqrt()) <= 1e-5 * float(
        want.pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("t,hq,hkv", [(77, 28, 4), (333, 64, 8), (914, 28, 4)])
def test_fp32_body_on_cuda(causal, d, t, hq, hkv):
    """The fp32 body at lengths that are no multiple of its 128-row items
    or 64-key tiles, GQA 28:4 and 64:8, both head widths, with a [B, S]
    key mask: batch 0 loses key 0, keys 64-127 (a whole tile) and a
    scattered tenth; batch 1 loses every key, so its output is exactly 0,
    and under causal so is batch 0's row 0, which sees only key 0. One
    launch a call, within the fp32 bound (and 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = make(2, t, t, hq, hkv, d, seed=t + d)
    rng = np.random.default_rng(t)
    mask = rng.random((2, t)) > 0.1
    mask[0, 0] = False
    mask[0, 64:128] = False
    mask[1] = False
    args = [torch.from_numpy(x).cuda() for x in (q, k, v)]
    m = torch.from_numpy(mask).cuda()
    before = flash_attention.launches
    got = flash_attention(*args, m, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(*args, m, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert_fp32_close(got[0], want[0])
    assert bool((got[1] == 0).all())
    if causal:
        assert bool((got[0, 0] == 0).all())
