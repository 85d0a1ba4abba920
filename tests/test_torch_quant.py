"""The port's weight-only int8 path against the JAX package.

``quantize_tree`` must give JAX's int8 weights and scales bit for bit (in
the port's transposed layout). ``linear`` on an int8 weight, at a
decode-shaped lead (≤ 32 rows: the int8 kernel's plain version on the
CPU) and at a prefill-shaped lead (the dequantised product), and the int8
``lm_logits`` are held against JAX's CPU path in fp32 within 1e-5 of the
output's largest magnitude (the same sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from handwritten_ocr_tpu.models import layers as jl
from handwritten_ocr_tpu.models.quant import quantize_tree as jax_quantize
from handwritten_ocr_tpu.models.qwen25vl.language import (
    lm_logits as jax_lm_logits)
from handwritten_ocr_tpu_torch.models import layers as tl
from handwritten_ocr_tpu_torch.models.quant import (dequantize_weight,
                                                    quantize_tree,
                                                    quantized_bytes)
from handwritten_ocr_tpu_torch.models.qwen25vl.language import lm_logits
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
from handwritten_ocr_tpu_torch.models.weights import from_jax_params


def close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def weights(rng, d_in, d_out):
    return rng.normal(0, 0.05, (d_in, d_out)).astype(np.float32)


def test_quantize_tree_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    tree = {"q": {"w": weights(rng, 64, 96),
                  "b": rng.normal(0, 0.1, 96).astype(np.float32)},
            "gate": {"w": weights(rng, 64, 200)},
            "lm_head": {"w": weights(rng, 64, 300)},
            "ln1": {"scale": np.ones(64, np.float32)},
            "embed": {"w": weights(rng, 300, 64)}}
    tree["gate"]["w"][:, 7] = 0.0            # an all-zero channel: floor 1e-8
    want = jax.tree_util.tree_map(np.asarray, jax_quantize(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    port = {k: {n: torch.from_numpy(np.ascontiguousarray(
                    a.T if n == "w" and k != "embed" else a))
                for n, a in v.items()} for k, v in tree.items()}
    got = quantize_tree(port)
    for key in ("q", "gate", "lm_head"):
        assert got[key]["w_q"].dtype == torch.int8
        assert got[key]["w_scale"].dtype == torch.float32
        np.testing.assert_array_equal(got[key]["w_q"].numpy(),
                                      want[key]["w_q"].T)
        np.testing.assert_array_equal(got[key]["w_scale"].numpy(),
                                      want[key]["w_scale"])
    np.testing.assert_array_equal(got["q"]["b"].numpy(), want["q"]["b"])
    assert got["embed"].keys() == {"w"} and got["ln1"].keys() == {"scale"}
    # the carried-over JAX tree is the same tree
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(from_jax_params(want)), _leaves(got)))
    deq = dequantize_weight(got["gate"], torch.float32)
    np.testing.assert_allclose(deq.numpy(), tree["gate"]["w"].T,
                               atol=float(got["gate"]["w_scale"].max()))
    assert quantized_bytes(got) == sum(a.numel() * a.element_size()
                                       for a in _leaves(got))


def _leaves(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    else:
        yield tree


@pytest.mark.parametrize("jax_int8", ["off", "interpret"])
@pytest.mark.parametrize("lead", [(3,), (2, 16), (5, 9)])
@pytest.mark.parametrize("d_in,d_out", [(64, 96), (256, 300)])
def test_int8_linear_matches_jax(lead, d_in, d_out, jax_int8, monkeypatch):
    """(3,) and (2, 16): ≤ 32 rows (the kernel path where both dims are
    ≥ 128); (5, 9): 45 rows, the dequantised product. The JAX side runs
    its XLA product (``HOCR_TPU_INT8=off``, its CPU default) or its Pallas
    kernel in the interpreter where it would take the kernel."""
    monkeypatch.setenv("HOCR_TPU_INT8", jax_int8)
    rng = np.random.default_rng(d_out + len(lead))
    params = jax_quantize({"p": {"w": jnp.asarray(weights(rng, d_in, d_out)),
                                 "b": jnp.asarray(rng.normal(0, 0.1, d_out),
                                                  jnp.float32)}})["p"]
    x = rng.normal(0, 1, lead + (d_in,)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jl.linear(params, jnp.asarray(x))
    port = from_jax_params({"p": jax.tree_util.tree_map(np.asarray,
                                                        params)})["p"]
    got = tl.linear(port, torch.from_numpy(x))
    assert got.shape == lead + (d_out,)
    close(got, want)


@pytest.mark.parametrize("b,t", [(4, 1), (2, 24)])
def test_int8_lm_head_matches_jax(b, t):
    """b·t = 4 goes to the int8 kernel's plain version, b·t = 48 to the
    fp32 product of the widened weight; both return fp32 logits."""
    rng = np.random.default_rng(b * t)
    cfg = Qwen3Config(vocab_size=300, hidden_size=128)
    head = jax_quantize({"lm_head": {"w": jnp.asarray(
        weights(rng, 128, 300))}})
    hidden = rng.normal(0, 1, (b, t, 128)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_lm_logits(head, cfg, jnp.asarray(hidden))
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, head))
    got = lm_logits(port, cfg, torch.from_numpy(hidden))
    assert got.dtype == torch.float32 and got.shape == (b, t, 300)
    close(got, want)
    got16 = lm_logits(port, cfg, torch.from_numpy(hidden).bfloat16())
    assert got16.dtype == torch.float32
