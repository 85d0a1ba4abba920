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
    flash_attention, flash_attention_plain)

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("mask_rows", [1, 2])
def test_kernel_matches_plain_on_cuda(dtype, causal, d, mask_rows):
    """Kernel against its plain version on the card, at both head widths
    (vision 80, text 128; bf16 takes the tensor-core body) and with an
    [S] or a [B, S] key mask. fp32: 1e-4 (fp32 FMA in another order).
    bf16: 2e-2 absolute and relative elementwise (one bf16 rounding of
    the output, P rounded to bf16 against another running max), and the
    RMS of the error within 1% of the RMS of the output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = make(2, 200, 200, 8, 2, d, seed=6)
    mask = np.ones((mask_rows, 200), bool)
    mask[-1, 150:] = False
    mask[0, [3, 77]] = False
    args = [torch.from_numpy(x).to("cuda", dtype) for x in (q, k, v)]
    m = torch.from_numpy(mask[0] if mask_rows == 1 else mask).cuda()
    got = flash_attention(*args, m, causal=causal).float()
    want = flash_attention_plain(*args, m, causal=causal).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rel_rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert rel_rms <= 1e-2
