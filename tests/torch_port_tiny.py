"""Shared tiny Qwen2.5-VL fixtures for the PyTorch port's parity tests.

The weights are drawn by the JAX package's ``init_vl`` (fp32, seeded) and
carried over to the port with ``from_jax_params``, so both sides run the
same numbers.
"""

import numpy as np
import torch

import jax

from handwritten_ocr_tpu.models.init import init_vl as jax_init_vl
from handwritten_ocr_tpu.models.qwen25vl.config import (
    TextConfig as JaxTextConfig, VLConfig as JaxVLConfig,
    VisionConfig as JaxVisionConfig)
from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
    TextConfig, VLConfig, VisionConfig)
from handwritten_ocr_tpu_torch.models.weights import from_jax_params

torch.set_num_threads(1)

VISION = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=2,
              patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
              window_size=112, fullatt_block_indexes=(1,), out_hidden_size=64)


def text_kwargs(vocab_size):
    return dict(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, mrope_section=(2, 3, 3))


def configs(vocab_size=152064, **vl):
    """(JAX VLConfig, port VLConfig) with the same fields."""
    jax_cfg = JaxVLConfig(vision=JaxVisionConfig(**VISION),
                          text=JaxTextConfig(**text_kwargs(vocab_size)), **vl)
    port_cfg = VLConfig(vision=VisionConfig(**VISION),
                        text=TextConfig(**text_kwargs(vocab_size)), **vl)
    return jax_cfg, port_cfg


def jax_tree(jax_cfg, seed=0):
    """fp32 JAX parameters with non-trivial norms and biases (the init's
    ones and zeros would hide a transposed or dropped scale/bias)."""
    params = jax_init_vl(jax.random.PRNGKey(seed), jax_cfg, dtype=np.float32)
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        leaf = np.asarray(leaf)
        if "scale" in name:
            return (leaf + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        if name.endswith("['b']"):
            return rng.normal(0, 0.02, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, params)


def port_tree(tree):
    return from_jax_params(tree, device="cpu")
