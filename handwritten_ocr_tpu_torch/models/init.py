"""Random parameters drawn on the device (port of ``models/init.py``).

Same distributions as the JAX package's ``init_vl``: linear weights and
embeddings N(0, 0.02²), biases 0, norm scales 1. The numbers differ from
JAX's for the same seed (another generator); tests that compare the two
build the weights with JAX and carry them over with
:func:`handwritten_ocr_tpu_torch.models.weights.from_jax_params`.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.models.qwen25vl.config import (TextConfig,
                                                              VLConfig,
                                                              VisionConfig)


class _Init:
    """Draws tensors in PyTorch's layout from one seeded generator."""

    def __init__(self, dtype: torch.dtype, device, seed: int):
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def normal(self, *shape) -> torch.Tensor:
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return w.mul_(0.02).to(self.dtype)

    def linear(self, d_in: int, d_out: int, bias: bool = False) -> dict:
        params = {"w": self.normal(d_out, d_in)}
        if bias:
            params["b"] = torch.zeros(d_out, dtype=self.dtype, device=self.device)
        return params

    def norm(self, dim: int) -> dict:
        return {"scale": torch.ones(dim, dtype=self.dtype, device=self.device)}

    def mlp(self, d: int, inter: int, bias: bool) -> dict:
        return {"gate": self.linear(d, inter, bias),
                "up": self.linear(d, inter, bias),
                "down": self.linear(inter, d, bias)}


def _init_vision(init: _Init, cfg: VisionConfig) -> dict:
    patch_dim = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    d = cfg.hidden_size
    blocks = [{"norm1": init.norm(d), "norm2": init.norm(d),
               "attn": {"qkv": init.linear(d, 3 * d, bias=True),
                        "proj": init.linear(d, d, bias=True)},
               "mlp": init.mlp(d, cfg.intermediate_size, bias=True)}
              for _ in range(cfg.depth)]
    merged = d * cfg.spatial_merge_unit
    return {"patch_embed": init.linear(patch_dim, d),
            "blocks": blocks,
            "merger": {"ln_q": init.norm(d),
                       "fc1": init.linear(merged, merged, bias=True),
                       "fc2": init.linear(merged, cfg.out_hidden_size,
                                          bias=True)}}


def _init_text(init: _Init, cfg: TextConfig) -> dict:
    d, hd = cfg.hidden_size, cfg.head_dim
    layers = [{"ln1": init.norm(d), "ln2": init.norm(d),
               "attn": {"q": init.linear(d, cfg.num_attention_heads * hd, True),
                        "k": init.linear(d, cfg.num_key_value_heads * hd, True),
                        "v": init.linear(d, cfg.num_key_value_heads * hd, True),
                        "o": init.linear(cfg.num_attention_heads * hd, d)},
               "mlp": init.mlp(d, cfg.intermediate_size, bias=False)}
              for _ in range(cfg.num_hidden_layers)]
    tree = {"embed": {"w": init.normal(cfg.vocab_size, d)},
            "layers": layers,
            "final_norm": init.norm(d)}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = init.linear(d, cfg.vocab_size)
    return tree


def init_vl(config: VLConfig, dtype: torch.dtype = torch.bfloat16,
            device: str | torch.device = "cuda", seed: int = 0) -> dict:
    """Random VL parameters ``{"vision": ..., "text": ...}`` made directly
    on ``device`` (no host staging, so the 7B tree builds in seconds)."""
    init = _Init(dtype, device, seed)
    return {"vision": _init_vision(init, config.vision),
            "text": _init_text(init, config.text)}
