"""Seeded random weights in the port's parameter layout.

The benchmark, not the program, makes the weights, and makes them the
same way for both sides: the program receives them as its models take
them, and the plain reference draws any unit again from the seed and
gets the same numbers. A unit (one vision block, one text layer, the
embedding, ...) is one ``torch.randn`` call on the device from a
generator seeded by (seed, unit index), so the reference can draw layer
``i`` alone, without replaying the ones before it.

Projections and embeddings are N(0, 0.02^2), as the port's own
``models/init.py`` draws them; norm scales are 1 + N(0, 0.1^2) and
biases N(0, 0.02^2), so that a dropped scale or bias changes the result.
A configuration may state another ``init_std`` (the CPU tests' tiny
models do, so that their attention weighs as much as a full-width
model's: 0.02 x sqrt(3584) ~ 0.15 x sqrt(64)).
"""

from __future__ import annotations

import math

import torch

STD = 0.02
NORM_STD = 0.1


def unit_seed(seed: int, unit: int) -> int:
    """The generator seed of unit ``unit``: distinct for every unit of a
    model and every run seed, within the 63 bits a seed may have."""
    return (int(seed) * 1_000_003 + 7919 * (unit + 1)) % (1 << 63)


class Layout:
    """The leaves of one unit: (path, shape, kind) with kind ``w`` (a
    projection or embedding), ``b`` (bias) or ``s`` (norm scale)."""

    def __init__(self):
        self.leaves: list[tuple[tuple[str, ...], tuple[int, ...], str]] = []

    def linear(self, path: tuple[str, ...], d_in: int, d_out: int,
               bias: bool = False) -> None:
        self.leaves.append((path + ("w",), (d_out, d_in), "w"))
        if bias:
            self.leaves.append((path + ("b",), (d_out,), "b"))

    def norm(self, path: tuple[str, ...], dim: int) -> None:
        self.leaves.append((path + ("scale",), (dim,), "s"))

    def mlp(self, path, d: int, inter: int, bias: bool) -> None:
        self.linear(path + ("gate",), d, inter, bias)
        self.linear(path + ("up",), d, inter, bias)
        self.linear(path + ("down",), inter, d, bias)


def draw(layout: Layout, seed: int, unit: int, device,
         dtype: torch.dtype, std: float = STD) -> dict:
    """The unit's tree: one fp32 ``randn`` for all its leaves, scaled by
    kind (``std`` for projections, embeddings and biases), each leaf cast
    to ``dtype``."""
    total = sum(math.prod(shape) for _, shape, _ in layout.leaves)
    gen = torch.Generator(device=device).manual_seed(unit_seed(seed, unit))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    tree: dict = {}
    offset = 0
    for path, shape, kind in layout.leaves:
        n = math.prod(shape)
        leaf = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "s":
            leaf = leaf * NORM_STD + 1.0
        else:
            leaf = leaf * std
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf.to(dtype)
    return tree


# ── Qwen2.5-VL (olmOCR-2-7B) ─────────────────────────────────────────

def vl_units(cfg) -> list[tuple[str, Layout]]:
    """(name, layout) of every unit of a Qwen2.5-VL model in draw order;
    ``cfg`` is the port's ``VLConfig``."""
    v, t = cfg.vision, cfg.text
    units = []
    patch = Layout()
    patch.linear((), v.in_channels * v.temporal_patch_size * v.patch_size ** 2,
                 v.hidden_size)
    units.append(("vision.patch_embed", patch))
    for i in range(v.depth):
        block = Layout()
        block.norm(("norm1",), v.hidden_size)
        block.norm(("norm2",), v.hidden_size)
        block.linear(("attn", "qkv"), v.hidden_size, 3 * v.hidden_size, True)
        block.linear(("attn", "proj"), v.hidden_size, v.hidden_size, True)
        block.mlp(("mlp",), v.hidden_size, v.intermediate_size, True)
        units.append((f"vision.block.{i}", block))
    merged = v.hidden_size * v.spatial_merge_size ** 2
    merger = Layout()
    merger.norm(("ln_q",), v.hidden_size)
    merger.linear(("fc1",), merged, merged, True)
    merger.linear(("fc2",), merged, v.out_hidden_size, True)
    units.append(("vision.merger", merger))
    units.extend(text_units(t))
    return units


def text_units(t) -> list[tuple[str, Layout]]:
    """Units of the Qwen2 decoder: q/k/v biases, untied or tied head."""
    d, hd = t.hidden_size, t.head_dim
    embed = Layout()
    embed.leaves.append((("w",), (t.vocab_size, d), "w"))
    units = [("text.embed", embed)]
    for i in range(t.num_hidden_layers):
        layer = Layout()
        layer.norm(("ln1",), d)
        layer.norm(("ln2",), d)
        layer.linear(("attn", "q"), d, t.num_attention_heads * hd, True)
        layer.linear(("attn", "k"), d, t.num_key_value_heads * hd, True)
        layer.linear(("attn", "v"), d, t.num_key_value_heads * hd, True)
        layer.linear(("attn", "o"), t.num_attention_heads * hd, d)
        layer.mlp(("mlp",), d, t.intermediate_size, False)
        units.append((f"text.layer.{i}", layer))
    final = Layout()
    final.norm((), d)
    units.append(("text.final_norm", final))
    if not t.tie_word_embeddings:
        head = Layout()
        head.linear((), d, t.vocab_size)
        units.append(("text.lm_head", head))
    return units


def unit_index(units, name: str) -> int:
    for index, (unit, _) in enumerate(units):
        if unit == name:
            return index
    raise KeyError(name)


def draw_unit(units, name: str, seed: int, device,
              dtype: torch.dtype, std: float = STD) -> dict:
    index = unit_index(units, name)
    return draw(units[index][1], seed, index, device, dtype, std)


def assemble(units, seed: int, device, dtype: torch.dtype,
             std: float = STD) -> dict:
    """The whole tree in the port's layout (``vision``, ``text``), drawn
    unit by unit."""
    tree: dict = {}
    for index, (name, layout) in enumerate(units):
        sub = draw(layout, seed, index, device, dtype, std)
        parts = name.split(".")
        root = tree.setdefault(parts[0], {})
        key = parts[1]
        if key in ("block", "layer"):
            root.setdefault("blocks" if key == "block" else "layers",
                            []).append(sub)
        else:
            root[key] = sub
    return tree
