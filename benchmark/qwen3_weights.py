"""Seeded random weights of a Qwen3 decoder, served with int8 weights.

The units and their draw are ``weights.py``'s (one ``randn`` on the
device per unit, from a generator seeded by (seed, unit index), so the
reference can draw layer ``i`` alone); a Qwen3 layer has no biases and
an RMSNorm scale over the head dim on q and on k (``q_norm``,
``k_norm``: 1 + N(0, 0.1^2) like the other norms).

The weights are drawn in bf16, as a published checkpoint holds them.
The program gets every projection and the lm_head quantised by its own
``models/quant.py:quantize_tree``, as ``TorchReasoningBackend.
from_pretrained(quantize="int8")`` does; the reference gets the same
leaves rounded by :func:`round_int` below and widened to fp32, so that it
sees the weights the program serves (``test_bench_qwen3.py`` holds the
two roundings equal).
"""

from __future__ import annotations

import torch

from benchmark.weights import STD, Layout, draw, unit_index

# The leaves that are served as int8: the attention and MLP projections
# of every layer (``models/quant.py``'s set for a Qwen3 tree) and the
# untied lm_head.
PROJECTIONS = ("q", "k", "v", "o", "gate", "up", "down")


def units(cfg) -> list[tuple[str, Layout]]:
    """(name, layout) of every unit of a Qwen3 decoder in draw order;
    ``cfg`` is the port's ``Qwen3Config``."""
    d, hd = cfg.hidden_size, cfg.head_dim
    embed = Layout()
    embed.leaves.append((("w",), (cfg.vocab_size, d), "w"))
    out = [("text.embed", embed)]
    for i in range(cfg.num_hidden_layers):
        layer = Layout()
        layer.norm(("ln1",), d)
        layer.norm(("ln2",), d)
        layer.linear(("attn", "q"), d, cfg.num_attention_heads * hd)
        layer.linear(("attn", "k"), d, cfg.num_key_value_heads * hd)
        layer.linear(("attn", "v"), d, cfg.num_key_value_heads * hd)
        layer.linear(("attn", "o"), cfg.num_attention_heads * hd, d)
        layer.norm(("attn", "q_norm"), hd)
        layer.norm(("attn", "k_norm"), hd)
        layer.mlp(("mlp",), d, cfg.intermediate_size, False)
        out.append((f"text.layer.{i}", layer))
    final = Layout()
    final.norm((), d)
    out.append(("text.final_norm", final))
    if not cfg.tie_word_embeddings:
        head = Layout()
        head.linear((), d, cfg.vocab_size)
        out.append(("text.lm_head", head))
    return out


def round_int(w: torch.Tensor, levels: int = 127):
    """Per-output-channel absmax rounding of ``w [out, in]`` to the
    integers in [-levels, levels]: (int8 values, fp32 scale [out]), scale
    = max(absmax, 1e-8) / levels, round half to even. ``levels`` 127 is
    int8; 7 is int4, the control's precision."""
    w = w.float()
    absmax = w.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA's division by a Python scalar multiplies by
    # its reciprocal, which is not the rounded quotient
    scale = torch.clamp_min(absmax, 1e-8) / w.new_full((), float(levels))
    w_q = torch.clamp(torch.round(w / scale), -levels, levels)
    return w_q.to(torch.int8), scale.squeeze(-1)


def _served(name: str, tree: dict, levels: int | None) -> dict:
    """A bf16 unit as the program takes it: its projections as
    ``{"w_q", "w_scale"}``, by the program's ``quantize_tree`` (``levels``
    None) or rounded to ``levels`` here (the control)."""
    from handwritten_ocr_tpu_torch.models.quant import quantize_tree
    if name == "text.lm_head":
        tree = {"lm_head": tree}
    if levels is None:
        tree = quantize_tree(tree)
    else:
        tree = _round_projections(tree, levels)
    return tree["lm_head"] if name == "text.lm_head" else tree


def _round_projections(tree, levels: int):
    out = {}
    for key, value in tree.items():
        if key in PROJECTIONS + ("lm_head",) and "w" in value:
            w_q, scale = round_int(value["w"], levels)
            out[key] = {"w_q": w_q, "w_scale": scale}
        elif isinstance(value, dict):
            out[key] = _round_projections(value, levels)
        else:
            out[key] = value
    return out


def program_params(unit_list, seed: int, device, levels: int | None = None,
                   std: float = STD) -> dict:
    """The program's text tree (embed / layers / final_norm / lm_head),
    drawn unit by unit in bf16 and quantised at once, so a bf16 copy of
    the whole model never exists."""
    tree: dict = {"layers": []}
    for index, (name, layout) in enumerate(unit_list):
        unit = _served(name, draw(layout, seed, index, device,
                                  torch.bfloat16, std), levels)
        key = name.split(".")[1]
        if key == "layer":
            tree["layers"].append(unit)
        else:
            tree[key] = unit
    return tree


def reference_unit(unit_list, name: str, seed: int, device,
                   std: float = STD) -> dict:
    """Unit ``name`` in fp32 as the program serves it: drawn again from
    the seed in bf16, each projection rounded to int8 by
    :func:`round_int` and widened again."""
    index = unit_index(unit_list, name)
    tree = draw(unit_list[index][1], seed, index, device, torch.bfloat16, std)

    def widen(node, key=None):
        if isinstance(node, dict):
            if "w" in node and (key in PROJECTIONS or name == "text.lm_head"):
                w_q, scale = round_int(node["w"])
                return {"w": w_q.float() * scale[:, None]}
            return {k: widen(v, k) for k, v in node.items()}
        return node.float()

    return widen(tree)
