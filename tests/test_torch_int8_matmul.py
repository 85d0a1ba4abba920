"""The port's int8 weight matmul against the JAX Pallas kernel.

The JAX kernel runs through the Pallas interpreter with exact fp32
products; the port's CPU path is its plain version (weights in the port's
``[out, in]`` layout, the transpose of JAX's). Shapes are ragged in both
dims (no weight padding on either side). fp32: 1e-5 relative (the same
sum in another order; relative to the output's largest magnitude, since a
sum of mixed signs can be small). bf16 x: the products are exact in both,
so the fp32 sums agree as closely and a bf16 output differs by at most
one bf16 ulp (2^-7 relative). JAX is imported inside the parity tests, so the CUDA
case also runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.ops.int8_matmul import (int8_matmul,
                                                       int8_matmul_plain,
                                                       int8_matmul_supported)

SHAPES = [(4, 256, 512), (3, 300, 1187), (24, 384, 896), (32, 128, 130)]


def make(m, d_in, d_out, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d_in)).astype(np.float32)
    w8 = rng.integers(-127, 128, (d_in, d_out)).astype(np.int8)   # JAX [in, out]
    scale = (rng.random(d_out) * 0.02 + 0.001).astype(np.float32)
    return x, w8, scale


def run_jax(x, w8, scale, x_dtype, out_dtype):
    import jax
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.int8_matmul import int8_matmul as jax_int8
    with jax.default_matmul_precision("highest"):
        out = jax_int8(jnp.asarray(x, dtype=getattr(jnp, x_dtype)),
                       jnp.asarray(w8), jnp.asarray(scale),
                       out_dtype=getattr(jnp, out_dtype), interpret=True)
    return np.asarray(out.astype(jnp.float32))


def run_port(x, w8, scale, x_dtype, out_dtype):
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    out = int8_matmul(xt, torch.from_numpy(np.ascontiguousarray(w8.T)),
                      torch.from_numpy(scale),
                      out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    assert out.shape == (x.shape[0], w8.shape[1])
    return out.float().numpy()


@pytest.mark.parametrize("m,d_in,d_out", SHAPES)
def test_fp32_matches_jax_kernel(m, d_in, d_out):
    x, w8, scale = make(m, d_in, d_out, seed=d_out)
    got = run_port(x, w8, scale, "float32", "float32")
    want = run_jax(x, w8, scale, "float32", "float32")
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d_in,d_out", SHAPES[1:3])
def test_bf16_matches_jax_kernel(m, d_in, d_out, out_dtype):
    x, w8, scale = make(m, d_in, d_out, seed=d_in)
    got = run_port(x, w8, scale, "bfloat16", out_dtype)
    want = run_jax(x, w8, scale, "bfloat16", out_dtype)
    peak = np.abs(want).max()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * peak)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=1e-5 * peak)


def test_supported_rule_and_input_checks():
    assert int8_matmul_supported(5120, 151936)
    assert not int8_matmul_supported(100, 512)
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="int8"):
        int8_matmul(x, torch.zeros((4, 8)), torch.ones(4))
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(x, torch.zeros((4, 8), dtype=torch.int8), torch.ones(3))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("m,d_in,d_out", SHAPES + [(24, 5120, 1024),
                                                  (8, 25600, 640)])
def test_kernel_matches_plain_on_cuda(m, d_in, d_out, x_dtype, out_dtype):
    """Kernel against its plain version on the card: fp32 sums in another
    order (1e-5 relative to the output's scale), then one rounding to the
    output dtype (one bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w8, scale = make(m, d_in, d_out, seed=m + d_in)
    xt = torch.from_numpy(x).cuda().to(x_dtype)
    w = torch.from_numpy(np.ascontiguousarray(w8.T)).cuda()
    s = torch.from_numpy(scale).cuda()
    before = int8_matmul.launches
    got = int8_matmul(xt, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    want = int8_matmul_plain(xt, w, s, out_dtype).float()
    peak = float(want.abs().max())
    tol = 1e-5 * peak if out_dtype == torch.float32 else 2.0 ** -7 * peak
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


def assert_close_to_plain(got, want):
    """The kernel's bf16 output against its plain version: the largest
    error within 2 bf16 ulps of max|want| (two fp32 sums of the same terms
    in another order round at most one ulp apart, one more covers their
    fp32 difference) and the RMS error within 1% of RMS(want)."""
    got, want = got.float(), want.float()
    peak = float(want.abs().max())
    diff = got - want
    assert float(diff.abs().max()) <= 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
    assert float(diff.pow(2).mean().sqrt()) <= 1e-2 * float(
        want.pow(2).mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 24, 32])
@pytest.mark.parametrize("d_in,d_out,out_dtype", [
    (384, 130, torch.bfloat16),       # ragged N, K a whole number of tiles
    (336, 1187, torch.bfloat16),      # ragged N, ragged last k tile
    (300, 896, torch.bfloat16),       # K % 16 != 0: the unaligned loads
    (5120, 1024, torch.bfloat16),     # qwen3:32b k/v: split K
    (5120, 25600, torch.bfloat16),    # qwen3:32b gate/up
    (5120, 151936, torch.float32),    # qwen3:32b lm_head
])
def test_bf16_kernel_on_cuda(m, d_in, d_out, out_dtype):
    """The tensor-core kernel at decode shapes: within the plain version's
    tolerance, one launch per call, and two calls bit-equal (the fixed
    split order of the merge, the counters reset to 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m + d_out)
    x = torch.randn((m, d_in), generator=gen, device="cuda").bfloat16()
    w = torch.randint(-127, 128, (d_out, d_in), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(d_out, generator=gen, device="cuda") * 1e-3 + 1e-4
    before = int8_matmul.launches
    got = int8_matmul(x, w, s, out_dtype=out_dtype)
    again = int8_matmul(x, w, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 2
    assert torch.equal(got, again)
    assert_close_to_plain(got, int8_matmul_plain(x, w, s, out_dtype))


@pytest.mark.cuda
def test_bf16_kernel_unaligned_x_on_cuda():
    """x 2 bytes off a 16-byte boundary takes the byte-load path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    m, d_in, d_out = 24, 5120, 1024
    flat = torch.randn(m * d_in + 1, generator=gen, device="cuda").bfloat16()
    x = flat[1:].view(m, d_in)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    w = torch.randint(-127, 128, (d_out, d_in), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(d_out, generator=gen, device="cuda") * 1e-3 + 1e-4
    got = int8_matmul(x, w, s)
    assert torch.equal(got, int8_matmul(x, w, s))
    assert_close_to_plain(got, int8_matmul_plain(x, w, s))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 24, 32])
@pytest.mark.parametrize("d_in,d_out", [
    (384, 130),        # ragged N, K a whole number of tiles
    (336, 1187),       # ragged N, ragged last k tile
    (300, 896),        # K % 16 != 0: the unaligned loads
    (4100, 259),       # unaligned, split K, ragged N
    (5120, 1024),      # qwen3:32b k/v: split K
    (5120, 25600),     # qwen3:32b gate/up: split K over 200 blocks
])
def test_fp32_x_kernel_on_cuda(m, d_in, d_out):
    """The fp32-x FMA body: within 1e-5 of the plain version's largest
    output (the same fp32 products summed in another order), one launch
    per call, and two calls bit-equal (the split merge's fixed order and
    the counters' reset)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(m + d_in + d_out)
    x = torch.randn((m, d_in), generator=gen, device="cuda")
    w = torch.randint(-127, 128, (d_out, d_in), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand(d_out, generator=gen, device="cuda") * 1e-3 + 1e-4
    before = int8_matmul.launches
    got = int8_matmul(x, w, s)
    again = int8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = int8_matmul_plain(x, w, s)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
