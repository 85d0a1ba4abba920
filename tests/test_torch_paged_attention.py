"""Fused append + paged attention of the PyTorch port against the JAX
Pallas kernel (fp KV).

The JAX kernel runs through the Pallas interpreter with exact fp32
matmuls; the port's CPU path is its plain version. Compared: the output of
every valid query row (2e-5, fp32 in another summation order) and the
whole pools after the append (bit-equal: appends copy values). JAX is
imported inside the parity tests, so the CUDA case also runs where JAX is
not installed.
"""

import numpy as np
import pytest
import torch

from handwritten_ocr_tpu_torch.ops.paged_decode_attention import (
    paged_append_attention, paged_append_attention_plain)

L, N, BS, HKV, D, HQ, LAYER = 2, 16, 16, 2, 128, 6, 1


def make(t, start, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    s = len(start)
    arrays = dict(
        q=rng.standard_normal((s, t, HQ, D)).astype(np.float32),
        k_new=rng.standard_normal((s, t, HKV, D)).astype(np.float32),
        v_new=rng.standard_normal((s, t, HKV, D)).astype(np.float32),
        k_pool=rng.standard_normal((L, N, BS, HKV, D)).astype(np.float32),
        v_pool=rng.standard_normal((L, N, BS, HKV, D)).astype(np.float32),
        tables=rng.permutation(np.arange(1, N))[:s * 3].reshape(s, 3)
        .astype(np.int32),
        start=np.asarray(start, np.int32),
        n_valid=np.asarray(n_valid, np.int32))
    return arrays


def run_port(a, fn=paged_append_attention):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    out = fn(t["q"], t["k_new"], t["v_new"], t["k_pool"], t["v_pool"],
             t["tables"], t["start"], t["n_valid"], layer=LAYER,
             scale=D ** -0.5)
    return out.numpy(), t["k_pool"].numpy(), t["v_pool"].numpy()


def run_jax(a):
    import jax
    import jax.numpy as jnp
    from handwritten_ocr_tpu.ops.paged_decode_attention import (
        paged_append_attention as jax_paged)
    with jax.default_matmul_precision("highest"):
        out, k2, v2 = jax_paged(
            *(jnp.asarray(a[k]) for k in ("q", "k_new", "v_new", "k_pool",
                                          "v_pool", "tables", "start",
                                          "n_valid")),
            layer=LAYER, scale=D ** -0.5, interpret=True)
    return np.asarray(out), np.asarray(k2), np.asarray(v2)


@pytest.mark.parametrize("t,start,n_valid", [
    (1, [5, 15, 0, 40], [1, 1, 1, 0]),     # decode: mid-page, boundary, dead
    (5, [15, 3, 30], [5, 3, 0]),           # 15+5 crosses a page boundary
])
def test_matches_jax_kernel(t, start, n_valid):
    a = make(t, start, n_valid, seed=t)
    out, k_pool, v_pool = run_port(a)
    want, want_k, want_v = run_jax(a)
    for s, nv in enumerate(n_valid):
        np.testing.assert_allclose(out[s, :nv], want[s, :nv],
                                   rtol=2e-5, atol=2e-5)
        assert np.all(out[s, nv:] == 0.0)
    np.testing.assert_array_equal(k_pool, want_k)
    np.testing.assert_array_equal(v_pool, want_v)


def test_dead_slots_leave_the_pool_untouched():
    a = make(1, [3, 9], [0, 0], seed=7)
    out, k_pool, v_pool = run_port(a)
    np.testing.assert_array_equal(k_pool, a["k_pool"])
    np.testing.assert_array_equal(v_pool, a["v_pool"])
    assert np.all(out == 0.0)


def test_int8_kv_is_not_ported_yet():
    a = make(1, [3], [1])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    scales = torch.zeros((L, N, HKV, BS))
    with pytest.raises(NotImplementedError, match="int8 KV: next slice"):
        paged_append_attention(t["q"], t["k_new"], t["v_new"], t["k_pool"],
                               t["v_pool"], t["tables"], t["start"],
                               t["n_valid"], scales, scales, layer=LAYER,
                               scale=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 5])
def test_kernel_matches_plain_on_cuda(dtype, t):
    """Kernel against its plain version on the card: outputs of valid rows
    within 1e-4 (fp32) or 2e-2 (bf16 output rounding), pools bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = make(t, [15, 3, 30, 0], [t, min(t, 3), 0, t], seed=11)
    dev = {k: torch.from_numpy(v).cuda() for k, v in a.items()}
    for k in ("q", "k_new", "v_new", "k_pool", "v_pool"):
        dev[k] = dev[k].to(dtype)
    plain = {k: v.clone() for k, v in dev.items()}
    names = ("q", "k_new", "v_new", "k_pool", "v_pool", "tables", "start",
             "n_valid")
    got = paged_append_attention(*(dev[k] for k in names), layer=LAYER,
                                 scale=D ** -0.5).float()
    want = paged_append_attention_plain(*(plain[k] for k in names),
                                        layer=LAYER, scale=D ** -0.5).float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(dev["k_pool"], plain["k_pool"])
    assert torch.equal(dev["v_pool"], plain["v_pool"])
