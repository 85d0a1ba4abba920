"""Random parameters drawn on the device (port of ``models/init.py``).

Same distributions as the JAX package's ``init_vl`` / ``init_qwen3``:
linear weights and embeddings N(0, 0.02²), biases 0, norm scales 1. The
numbers differ from JAX's for the same seed (another generator); tests
that compare the two build the weights with JAX and carry them over with
:func:`handwritten_ocr_tpu_torch.models.weights.from_jax_params`.

With a ``mesh`` each rank draws the whole model from the same seed, one
layer at a time, and keeps only its tensor-parallel slices of each
(``parallel/sharding.py``): the same numbers as the unsharded tree's
slices, and no rank ever holds a whole model.
"""

from __future__ import annotations

import torch

from handwritten_ocr_tpu_torch.models.quant import _quantize_linear
from handwritten_ocr_tpu_torch.models.qwen25vl.config import (TextConfig,
                                                              VLConfig,
                                                              VisionConfig)
from handwritten_ocr_tpu_torch.parallel.sharding import shard_params


class _Init:
    """Draws tensors in PyTorch's layout from one seeded generator.

    With ``quantize`` every projection is drawn in fp32 and quantised to
    int8 at once (``models/quant.py``), one matrix at a time, so a
    full-precision tree never exists: the largest transient is one fp32
    matrix (the lm_head's)."""

    def __init__(self, dtype: torch.dtype, device, seed: int,
                 quantize: bool = False, mesh=None):
        self.dtype = dtype
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.quantize = quantize
        self.mesh = mesh

    def keep(self, path: tuple[str, ...], tree: dict) -> dict:
        """What this rank keeps of a subtree drawn whole: its slices
        under a mesh, else all of it."""
        if self.mesh is None:
            return tree
        return shard_params(self.mesh, tree, prefix=path)

    def normal(self, *shape, dtype: torch.dtype | None = None) -> torch.Tensor:
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return w.mul_(0.02).to(dtype or self.dtype)

    def linear(self, d_in: int, d_out: int, bias: bool = False) -> dict:
        if self.quantize:
            params = _quantize_linear(
                {"w": self.normal(d_out, d_in, dtype=torch.float32)})
        else:
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
    patch_embed = init.keep(("vision", "patch_embed"),
                            init.linear(patch_dim, d))
    blocks = [init.keep(("vision", "blocks", str(i)), {
        "norm1": init.norm(d), "norm2": init.norm(d),
        "attn": {"qkv": init.linear(d, 3 * d, bias=True),
                 "proj": init.linear(d, d, bias=True)},
        "mlp": init.mlp(d, cfg.intermediate_size, bias=True)})
        for i in range(cfg.depth)]
    merged = d * cfg.spatial_merge_unit
    return {"patch_embed": patch_embed,
            "blocks": blocks,
            "merger": init.keep(("vision", "merger"), {
                "ln_q": init.norm(d),
                "fc1": init.linear(merged, merged, bias=True),
                "fc2": init.linear(merged, cfg.out_hidden_size, bias=True)})}


def _init_text(init: _Init, cfg, qk_norm: bool = False,
               attn_bias: bool = True) -> dict:
    d, hd = cfg.hidden_size, cfg.head_dim
    layers = []
    for i in range(cfg.num_hidden_layers):
        attn = {"q": init.linear(d, cfg.num_attention_heads * hd, attn_bias),
                "k": init.linear(d, cfg.num_key_value_heads * hd, attn_bias),
                "v": init.linear(d, cfg.num_key_value_heads * hd, attn_bias),
                "o": init.linear(cfg.num_attention_heads * hd, d)}
        if qk_norm:
            attn["q_norm"], attn["k_norm"] = init.norm(hd), init.norm(hd)
        layers.append(init.keep(("layers", str(i)), {
            "ln1": init.norm(d), "ln2": init.norm(d), "attn": attn,
            "mlp": init.mlp(d, cfg.intermediate_size, bias=False)}))
    tree = {"embed": init.keep(("embed",),
                               {"w": init.normal(cfg.vocab_size, d)}),
            "layers": layers, "final_norm": init.norm(d)}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = init.keep(("lm_head",),
                                    init.linear(d, cfg.vocab_size))
    return tree


def init_vl(config: VLConfig, dtype: torch.dtype = torch.bfloat16,
            device: str | torch.device = "cuda", seed: int = 0,
            mesh=None) -> dict:
    """Random VL parameters ``{"vision": ..., "text": ...}`` made directly
    on ``device`` (no host staging, so the 7B tree builds in seconds);
    with ``mesh``, this rank's tensor-parallel slices of them."""
    init = _Init(dtype, device, seed, mesh=mesh)
    return {"vision": _init_vision(init, config.vision),
            "text": _init_text(init, config.text)}


def init_qwen3(config, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda", seed: int = 0,
               quantize: str | None = None, mesh=None) -> dict:
    """Random Qwen3 parameters (QK-norm, no attention biases) in the port's
    layout, made directly on ``device``. ``quantize="int8"`` draws every
    projection and the lm_head as int8 + fp32 scales, one matrix at a time
    (qwen3:32b: ~33.5 GB instead of 65.5 GB in bf16, which would not fit
    one 80 GB card beside anything else). With ``mesh``, this rank's
    tensor-parallel slices, each matrix quantised whole before it is
    sliced (a row-parallel scale spans every input column)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize {quantize!r}")
    init = _Init(dtype, device, seed, quantize=quantize == "int8", mesh=mesh)
    return _init_text(init, config, qk_norm=True, attn_bias=False)
