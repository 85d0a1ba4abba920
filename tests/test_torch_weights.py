"""``from_jax_params`` carries the JAX tree over exactly.

Every tensor equals its JAX counterpart bit for bit, up to the documented
layout change: linear weights [in, out] → [out, in], stacked [L, ...]
layers → a list of per-layer dicts; the embedding table is not transposed.
"""

import numpy as np
import torch

import jax

from torch_port_tiny import configs, jax_tree
from handwritten_ocr_tpu_torch.models.init import init_vl
from handwritten_ocr_tpu_torch.models.weights import from_jax_params


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def _port_leaf(port, path):
    node = port
    stacked = path[1] in ("blocks", "layers")
    for key in path[:2]:
        node = node[key]
    layers = node if stacked else [node]
    rest = path[2:] if stacked else path[2:]
    out = []
    for layer in layers:
        for key in rest:
            layer = layer[key]
        out.append(layer)
    return stacked, out


def test_every_tensor_carries_over():
    jax_cfg, _ = configs(vocab_size=300)
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg, seed=1))
    port = from_jax_params(tree)
    n = 0
    for path, leaf in _leaves(tree):
        stacked, tensors = _port_leaf(port, path)
        linear = path[-1] == "w" and path[-2] != "embed"
        want = [leaf[i] for i in range(leaf.shape[0])] if stacked else [leaf]
        assert len(tensors) == len(want)
        for got, ref in zip(tensors, want):
            ref = ref.T if linear else ref
            assert got.dtype == torch.float32 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), ref)
            n += 1
    assert n > 40
    assert len(port["vision"]["blocks"]) == jax_cfg.vision.depth
    assert len(port["text"]["layers"]) == jax_cfg.text.num_hidden_layers


def test_dtype_cast_and_bf16_source():
    jax_cfg, _ = configs(vocab_size=300)
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg, seed=2))
    port16 = from_jax_params(tree, dtype=torch.bfloat16)
    w = tree["text"]["lm_head"]["w"]
    got = port16["text"]["lm_head"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), torch.from_numpy(w.T.copy()).bfloat16().float())
    bf16_tree = {"text": {"lm_head": {"w": w.astype(jax.numpy.bfloat16)}}}
    again = from_jax_params(bf16_tree)["text"]["lm_head"]["w"]
    assert torch.equal(again, got)


def test_init_vl_layout_matches_from_jax_params():
    jax_cfg, port_cfg = configs(vocab_size=300)
    tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_cfg))
    carried = from_jax_params(tree)
    drawn = init_vl(port_cfg, dtype=torch.float32, device="cpu", seed=3)
    shapes = {p: tuple(t.shape) for p, t in _flat(carried)}
    assert shapes == {p: tuple(t.shape) for p, t in _flat(drawn)}
    again = init_vl(port_cfg, dtype=torch.float32, device="cpu", seed=3)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_flat(drawn), _flat(again)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flat(value, path + (key,))
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from _flat(value, path + (i,))
    else:
        yield path, tree


def test_int8_qwen3_tree_carries_over():
    """An int8 Qwen3 tree: ``w_q [L, in, out]`` → per layer ``[out, in]``
    int8, ``w_scale`` untransposed and fp32 whatever ``dtype`` asks, the
    stacked QK-norm scales unstacked per layer."""
    from handwritten_ocr_tpu.models.init import init_qwen3
    from handwritten_ocr_tpu.models.qwen3 import Qwen3Config
    cfg = Qwen3Config(vocab_size=300, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=16)
    tree = jax.tree_util.tree_map(np.asarray, init_qwen3(
        jax.random.PRNGKey(0), cfg, dtype=np.float32, quantize="int8"))
    port = from_jax_params(tree, dtype=torch.bfloat16)
    for i, layer in enumerate(port["layers"]):
        q = layer["attn"]["q"]
        assert set(q) == {"w_q", "w_scale"}
        assert q["w_q"].dtype == torch.int8 and q["w_q"].is_contiguous()
        np.testing.assert_array_equal(
            q["w_q"].numpy(), tree["layers"]["attn"]["q"]["w_q"][i].T)
        assert q["w_scale"].dtype == torch.float32
        np.testing.assert_array_equal(
            q["w_scale"].numpy(), tree["layers"]["attn"]["q"]["w_scale"][i])
        assert layer["attn"]["k_norm"]["scale"].shape == (16,)
        assert layer["attn"]["k_norm"]["scale"].dtype == torch.bfloat16
    assert port["lm_head"]["w_q"].shape == (300, 64)
    assert port["lm_head"]["w_scale"].dtype == torch.float32
    assert port["embed"]["w"].shape == (300, 64)
    assert port["embed"]["w"].dtype == torch.bfloat16
