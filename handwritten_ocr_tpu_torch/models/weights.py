"""Parameter trees in the port's layout: from HF snapshots, and from the
JAX package's trees.

HF snapshots (``load_flat_state``, ``convert_vl``, ``convert_qwen3``; port
of ``handwritten_ocr_tpu/models/weights.py``): the flat name → tensor map
of a directory of ``*.safetensors`` shards, read through the port's own
reader (``utils/safetensors.py``, memory-mapped), becomes the same tree
``from_jax_params`` gives of the JAX conversion. HF keeps linear weights
as ``[out, in]``, the port's layout, so nothing is transposed. Each
tensor is cast and placed on its device as it is converted, and with
``quantize="int8"`` each layer is quantised as soon as it is built, so a
full-precision tree of the 32B model never exists on the card.

JAX trees (``from_jax_params``): the JAX package (``models/init.py:init_vl``/``init_qwen3``,
``models/weights.py:convert_vl``/``convert_qwen3``) keeps linear weights as
``[in, out]`` and stacks the layers of a tower into ``[L, ...]`` arrays.
The port keeps PyTorch's ``[out, in]`` layout and a list of per-layer
dicts, so its forward is a Python loop over layers. int8 linears
(``{"w_q", "w_scale"}``, ``models/quant.py``) carry over the same way:
``w_q`` transposed, ``w_scale [out]`` as it is.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.quant import quantize_tree
from handwritten_ocr_tpu_torch.train.optim import AdamWState

# Subtrees whose leaves carry a leading layer axis in the JAX layout.
_STACKED = ("blocks", "layers")
# Subtrees whose "w" is a lookup table, not a linear weight.
_TABLES = ("embed",)
# Leaves that keep their dtype whatever ``dtype`` asks (int8 scales are
# fp32 by contract).
_KEEP_DTYPE = ("w_scale",)


def _tensor(array, device, dtype) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":        # ml_dtypes bf16: go through fp32
        tensor = torch.from_numpy(array.astype(np.float32)).to(torch.bfloat16)
    else:
        tensor = torch.from_numpy(np.array(array))      # a writable copy
    if dtype is not None and tensor.is_floating_point():
        tensor = tensor.to(dtype)
    return tensor.to(device)


def _convert(node, name: str, device, dtype):
    if not isinstance(node, dict):
        return _tensor(node, device, None if name in _KEEP_DTYPE else dtype)
    out = {key: _convert(value, key, device, dtype)
           for key, value in node.items()}
    for key in ("w", "w_q"):
        if key in out and name not in _TABLES:
            out[key] = out[key].transpose(-1, -2).contiguous()
    return out


def _unstack(node, index: int):
    if isinstance(node, dict):
        return {key: _unstack(value, index) for key, value in node.items()}
    return node[index].contiguous()


def _depth(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def from_jax_params(tree: dict, device: str | torch.device = "cpu",
                    dtype: torch.dtype | None = None) -> dict:
    """The port's parameters from a JAX tree of numpy arrays.

    ``tree`` has the ``init_vl`` / ``convert_vl`` layout (``{"vision":
    ..., "text": ...}``), or is a lone text tree (``init_qwen3`` /
    ``convert_qwen3``). Every linear weight (``w``, or int8 ``w_q``) comes
    out transposed to ``[out, in]``; stacked ``blocks``/``layers`` come out
    as lists of per-layer dicts; everything else is unchanged. With
    ``dtype`` set, floating tensors are cast to it, except the fp32
    ``w_scale`` of int8 linears.
    """
    def walk(node, name):
        if isinstance(node, dict) and name in _STACKED:
            stacked = _convert(node, name, device, dtype)
            return [_unstack(stacked, i) for i in range(_depth(stacked))]
        if isinstance(node, dict) and not (("w" in node or "w_q" in node)
                                           and name):
            return {key: walk(value, key) for key, value in node.items()}
        return _convert(node, name, device, dtype)

    return walk(tree, "")


def from_jax_opt_state(state, device: str | torch.device = "cpu"):
    """The port's AdamW state (``train/optim.py:AdamWState``) from an optax
    ``adamw`` state of numpy arrays, so a run resumes where JAX left off.

    ``state`` is optax's tuple ``(ScaleByAdamState(count, mu, nu), ...)``:
    the adam state, then the states of the weight decay and the learning
    rate, which are empty, or hold a schedule's count, which must equal
    the adam count. mu and nu come out laid out as :func:`from_jax_params`
    lays out the parameters, in their own dtype.
    """
    (count, mu, nu), *rest = state
    count = int(np.asarray(count))
    for extra in rest:
        if len(extra) and int(np.asarray(extra[0])) != count:
            raise ValueError(f"schedule count {extra[0]} != adam count "
                             f"{count}")
    return AdamWState(count=count, mu=from_jax_params(mu, device),
                      nu=from_jax_params(nu, device))


# ── HF snapshots ──────────────────────────────────────────────────────

def load_flat_state(source) -> dict[str, torch.Tensor]:
    """Flat name → tensor map of a snapshot (a ``.safetensors`` file, a
    directory of shards, or its ``model.safetensors.index.json``), of a
    mapping (tensors or numpy arrays), or of a module's ``state_dict``."""
    if isinstance(source, (str, Path)):
        from handwritten_ocr_tpu_torch.utils.safetensors import load_snapshot
        return load_snapshot(source)
    if isinstance(source, Mapping):
        return {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v)) for k, v in source.items()}
    return dict(source.state_dict())


class _Namer:
    """Resolves HF param names with an optional prefix fallback.

    Different checkpoint eras use ``model.language_model.*`` vs ``model.*``
    and ``model.visual.*`` vs ``visual.*``; try each candidate prefix.
    """

    def __init__(self, flat: dict[str, torch.Tensor], prefixes: list[str]):
        self.flat = flat
        self.prefixes = prefixes
        self.used: set[str] = set()

    def get(self, name: str) -> torch.Tensor:
        for prefix in self.prefixes:
            key = prefix + name
            if key in self.flat:
                self.used.add(key)
                return self.flat[key]
        raise KeyError(f"{name} (tried prefixes {self.prefixes})")

    def has(self, name: str) -> bool:
        return any(prefix + name in self.flat for prefix in self.prefixes)


class _Put:
    """Casts a source tensor to the tree's dtype and device; quantises a
    finished subtree's projections when asked."""

    def __init__(self, dtype, device, quantize: str | None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize {quantize!r}")
        self.dtype = dtype
        self.device = torch.device(device)
        self.quantize = quantize

    def __call__(self, tensor: torch.Tensor) -> torch.Tensor:
        return tensor.to(device=self.device, dtype=self.dtype).contiguous()

    def done(self, tree: dict) -> dict:
        return quantize_tree(tree) if self.quantize else tree


def _linear(namer: _Namer, name: str, put: _Put) -> dict:
    params = {"w": put(namer.get(f"{name}.weight"))}
    if namer.has(f"{name}.bias"):
        params["b"] = put(namer.get(f"{name}.bias"))
    return params


def _norm(namer: _Namer, name: str, put: _Put) -> dict:
    return {"scale": put(namer.get(f"{name}.weight"))}


def _mlp(namer: _Namer, base: str, put: _Put) -> dict:
    return {"gate": _linear(namer, f"{base}.gate_proj", put),
            "up": _linear(namer, f"{base}.up_proj", put),
            "down": _linear(namer, f"{base}.down_proj", put)}


def convert_vl(source, vl_config, dtype=torch.bfloat16, device="cpu",
               quantize: str | None = None) -> dict:
    """Qwen2.5-VL checkpoint → ``{"vision": ..., "text": ...}`` tree."""
    flat = load_flat_state(source)
    vis = _Namer(flat, ["model.visual.", "visual."])
    txt = _Namer(flat, ["model.language_model.", "model.", "language_model."])
    put = _Put(dtype, device, quantize)

    patch_w = vis.get("patch_embed.proj.weight")           # (D, C, T, ps, ps)
    vision = {
        "patch_embed": {"w": put(patch_w.reshape(patch_w.shape[0], -1))},
        "blocks": [put.done({
            "norm1": _norm(vis, f"blocks.{i}.norm1", put),
            "norm2": _norm(vis, f"blocks.{i}.norm2", put),
            "attn": {"qkv": _linear(vis, f"blocks.{i}.attn.qkv", put),
                     "proj": _linear(vis, f"blocks.{i}.attn.proj", put)},
            "mlp": _mlp(vis, f"blocks.{i}.mlp", put),
        }) for i in range(vl_config.vision.depth)],
        "merger": put.done({
            "ln_q": _norm(vis, "merger.ln_q", put),
            "fc1": _linear(vis, "merger.mlp.0", put),
            "fc2": _linear(vis, "merger.mlp.2", put),
        }),
    }
    text = _text_tree(txt, vl_config.text.num_hidden_layers, put,
                      qk_norm=False)
    if not vl_config.text.tie_word_embeddings:
        head = _Namer(flat, ["", "model."])
        text["lm_head"] = put.done({"lm_head": _linear(head, "lm_head", put)}
                                   )["lm_head"]
    return {"vision": vision, "text": text}


def convert_qwen3(source, config, dtype=torch.bfloat16, device="cpu",
                  quantize: str | None = None) -> dict:
    """Qwen3 causal-LM checkpoint → text tree (with per-head QK norms)."""
    flat = load_flat_state(source)
    txt = _Namer(flat, ["model.", ""])
    put = _Put(dtype, device, quantize)
    text = _text_tree(txt, config.num_hidden_layers, put, qk_norm=True)
    if not config.tie_word_embeddings:
        head = _Namer(flat, ["", "model."])
        text["lm_head"] = put.done({"lm_head": _linear(head, "lm_head", put)}
                                   )["lm_head"]
    return text


def _text_tree(txt: _Namer, num_layers: int, put: _Put, qk_norm: bool) -> dict:
    layers = []
    for i in range(num_layers):
        base = f"layers.{i}"
        attn = {
            "q": _linear(txt, f"{base}.self_attn.q_proj", put),
            "k": _linear(txt, f"{base}.self_attn.k_proj", put),
            "v": _linear(txt, f"{base}.self_attn.v_proj", put),
            "o": _linear(txt, f"{base}.self_attn.o_proj", put),
        }
        if qk_norm:
            attn["q_norm"] = _norm(txt, f"{base}.self_attn.q_norm", put)
            attn["k_norm"] = _norm(txt, f"{base}.self_attn.k_norm", put)
        layers.append(put.done({
            "ln1": _norm(txt, f"{base}.input_layernorm", put),
            "ln2": _norm(txt, f"{base}.post_attention_layernorm", put),
            "attn": attn,
            "mlp": _mlp(txt, f"{base}.mlp", put),
        }))
    return {
        "embed": {"w": put(txt.get("embed_tokens.weight"))},
        "layers": layers,
        "final_norm": _norm(txt, "norm", put),
    }


def hf_state(tree: dict, vl_config=None,
             prefix: str = "model.") -> dict[str, torch.Tensor]:
    """The inverse of :func:`convert_vl` / :func:`convert_qwen3` on a
    full-precision tree: HF names → tensors as an HF snapshot stores them
    (``model.visual.*`` for a VL tree's vision tower, whose
    ``vl_config`` gives the patch weight's 5-D shape; ``{prefix}*`` for a
    lone text tree; ``lm_head.weight``). Writes snapshots for tests and
    smoke runs."""
    flat: dict[str, torch.Tensor] = {}

    def linear(name, params):
        flat[f"{name}.weight"] = params["w"]
        if "b" in params:
            flat[f"{name}.bias"] = params["b"]

    def mlp(base, params):
        for key in ("gate", "up", "down"):
            linear(f"{base}.{key}_proj", params[key])

    text = tree.get("text", tree)
    if "vision" in tree:
        vis = tree["vision"]
        v = vl_config.vision
        flat["model.visual.patch_embed.proj.weight"] = \
            vis["patch_embed"]["w"].reshape(
                v.hidden_size, v.in_channels, v.temporal_patch_size,
                v.patch_size, v.patch_size)
        for i, block in enumerate(vis["blocks"]):
            base = f"model.visual.blocks.{i}"
            flat[f"{base}.norm1.weight"] = block["norm1"]["scale"]
            flat[f"{base}.norm2.weight"] = block["norm2"]["scale"]
            linear(f"{base}.attn.qkv", block["attn"]["qkv"])
            linear(f"{base}.attn.proj", block["attn"]["proj"])
            mlp(f"{base}.mlp", block["mlp"])
        merger = vis["merger"]
        flat["model.visual.merger.ln_q.weight"] = merger["ln_q"]["scale"]
        linear("model.visual.merger.mlp.0", merger["fc1"])
        linear("model.visual.merger.mlp.2", merger["fc2"])
        prefix = "model.language_model."
    flat[f"{prefix}embed_tokens.weight"] = text["embed"]["w"]
    flat[f"{prefix}norm.weight"] = text["final_norm"]["scale"]
    for i, layer in enumerate(text["layers"]):
        base = f"{prefix}layers.{i}"
        flat[f"{base}.input_layernorm.weight"] = layer["ln1"]["scale"]
        flat[f"{base}.post_attention_layernorm.weight"] = layer["ln2"]["scale"]
        attn = layer["attn"]
        for key in ("q", "k", "v", "o"):
            linear(f"{base}.self_attn.{key}_proj", attn[key])
        for key in ("q_norm", "k_norm"):
            if key in attn:
                flat[f"{base}.self_attn.{key}.weight"] = attn[key]["scale"]
        mlp(f"{base}.mlp", layer["mlp"])
    if "lm_head" in text:
        linear("lm_head", text["lm_head"])
    return flat


def hf_config(config) -> dict:
    """``config.json`` of a snapshot of ``config`` (a ``VLConfig`` or a
    ``Qwen3Config``), in HF's layout: what ``from_hf`` reads back."""
    def plain(value):
        return list(value) if isinstance(value, tuple) else value
    if hasattr(config, "vision"):
        text = {k: plain(v) for k, v in dataclasses.asdict(config.text).items()}
        mrope = text.pop("mrope_section")
        return {"model_type": "qwen2_5_vl", **text,
                "rope_scaling": {"type": "mrope", "mrope_section": mrope},
                "vision_config": {k: plain(v) for k, v in
                                  dataclasses.asdict(config.vision).items()},
                **{key: getattr(config, key) for key in (
                    "image_token_id", "video_token_id",
                    "vision_start_token_id", "vision_end_token_id",
                    "eos_token_id", "pad_token_id")}}
    return {"model_type": "qwen3", **dataclasses.asdict(config)}


def save_snapshot(directory: str | Path, tree: dict, config,
                  shards: int = 2) -> None:
    """Write ``tree`` (full precision, the port's layout) as an HF snapshot
    of ``config``: ``config.json`` and ``shards`` ``*.safetensors`` files
    with their index (``utils/safetensors.py:save_sharded``). The
    tokenizer files are the caller's."""
    from handwritten_ocr_tpu_torch.utils.safetensors import save_sharded
    directory = Path(directory)
    vl = hasattr(config, "vision")
    save_sharded(hf_state(tree, config if vl else None), directory, shards)
    (directory / "config.json").write_text(json.dumps(hf_config(config),
                                                      indent=2))
