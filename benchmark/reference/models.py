"""Plain float32 forward pass of Qwen2.5-VL (olmOCR-2-7B): the windowed
vision tower (2D rotary, 4x4-cell windows and the global blocks, RMSNorm,
SwiGLU with biases), the 2x2 patch merger, the image splice, and the Qwen2
decoder with M-RoPE (sections over the rotary half-dimension) and q/k/v
biases.

No cache, no batching, no kernels: every sequence runs whole, one layer at
a time (the weights of a layer are drawn once for all sequences and then
dropped), with causal softmax attention in float32 and TF32 off. The
weights come from ``weights(unit_name)``, a float32 tree per unit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HEAD_CHUNK = 8


def full_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def lin(p: dict, x: torch.Tensor) -> torch.Tensor:
    out = x @ p["w"].t()
    return out + p["b"] if "b" in p else out


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + turned * sin


def attend(q, k, v, mask) -> torch.Tensor:
    """q [T, Hq, D], k/v [S, Hkv, D], mask bool [T, S] (True = attend) or
    None; grouped query heads; [T, Hq, D]."""
    t, hq, d = q.shape
    group = hq // k.shape[1]
    out = torch.empty_like(q)
    for lo in range(0, hq, HEAD_CHUNK):
        heads = torch.arange(lo, min(lo + HEAD_CHUNK, hq), device=q.device)
        qh = q[:, heads].transpose(0, 1)                      # [h, T, D]
        kh = k[:, heads // group].transpose(0, 1)
        vh = v[:, heads // group].transpose(0, 1)
        scores = qh @ kh.transpose(1, 2) / math.sqrt(d)
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        out[:, heads] = (torch.softmax(scores, -1) @ vh).transpose(0, 1)
    return out


def rope_tables(positions: np.ndarray, head_dim: int, theta: float,
                sections=None, device="cpu"):
    """cos/sin [T, head_dim]: 1D positions [T], or M-RoPE [3, T] whose
    rotary half-dimension is cut into ``sections``, chunk i taken from
    plane i % 3."""
    inv = 1.0 / theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                          / head_dim)
    if sections is None:
        half = positions[:, None] * inv[None]
    else:
        parts, start = [], 0
        for i, n in enumerate(sections):
            parts.append(positions[i % 3][:, None] * inv[None, start:start + n])
            start += n
        half = np.concatenate(parts, axis=1)
    emb = np.concatenate([half, half], axis=1)
    return (torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device))


# ── vision tower ────────────────────────────────────────────────────

def vision(weights, vcfg, images: list[tuple[np.ndarray, tuple]],
           device) -> list[torch.Tensor]:
    """Merged image embeddings [cells, out_hidden] of each (patches, grid);
    patches in cell-major order as the processor packs them."""
    merge, hd = vcfg.spatial_merge_size, vcfg.hidden_size // vcfg.num_heads
    unit = merge * merge
    win = vcfg.window_size // merge // vcfg.patch_size
    state = []
    embed = weights("vision.patch_embed")
    for patch_rows, (t, h, w) in images:
        x = torch.as_tensor(patch_rows, dtype=torch.float32, device=device)
        x = x @ embed["w"].t()
        ch, cw = h // merge, w // merge
        cell = np.arange(t * ch * cw)
        row, col = (cell // cw) % ch, cell % cw
        hpos = (row[:, None] * merge + np.arange(unit)[None] // merge).reshape(-1)
        wpos = (col[:, None] * merge + np.arange(unit)[None] % merge).reshape(-1)
        inv = 1.0 / vcfg.rope_theta ** (np.arange(0, hd // 2, 2) / (hd // 2))
        rot = np.concatenate([hpos[:, None] * inv, wpos[:, None] * inv], 1)
        emb = np.concatenate([rot, rot], 1)
        cos = torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device)
        sin = torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device)
        n_win_w = -(-cw // win) + (1 if cw % win == 0 else 0)
        window = np.repeat((row // win) * n_win_w + col // win, unit)
        groups = [torch.as_tensor(np.flatnonzero(window == wid), device=device)
                  for wid in np.unique(window)]
        state.append([x, cos[:, None], sin[:, None], groups])
    del embed
    heads = vcfg.num_heads
    for i in range(vcfg.depth):
        p = weights(f"vision.block.{i}")
        full = i in set(vcfg.fullatt_block_indexes)
        for item in state:
            x, cos, sin, groups = item
            qkv = lin(p["attn"]["qkv"], rms(x, p["norm1"]["scale"], 1e-6))
            q, k, v = qkv.reshape(x.shape[0], 3, heads, hd).unbind(1)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
            if full:
                out = attend(q, k, v, None)
            else:
                out = torch.empty_like(q)
                for index in groups:
                    out[index] = attend(q[index], k[index], v[index], None)
            x = x + lin(p["attn"]["proj"], out.reshape(x.shape[0], -1))
            m = p["mlp"]
            h2 = rms(x, p["norm2"]["scale"], 1e-6)
            x = x + lin(m["down"], torch.nn.functional.silu(lin(m["gate"], h2))
                        * lin(m["up"], h2))
            item[0] = x
        del p
    p = weights("vision.merger")
    outs = []
    for x, *_ in state:
        x = rms(x, p["ln_q"]["scale"], 1e-6).reshape(-1, unit * x.shape[-1])
        outs.append(lin(p["fc2"], torch.nn.functional.gelu(lin(p["fc1"], x))))
    return outs


# ── decoder ─────────────────────────────────────────────────────────

def decoder_logits(weights, tcfg, seqs: list[dict], device) -> list[torch.Tensor]:
    """float32 logits [len(want), V] of each sequence: ``ids`` [T] (int),
    ``positions`` ([T] or [3, T]), optional ``image`` (embeddings placed at
    the ``image_token`` ids among the first ``prompt`` ids, in order) and
    ``want`` (the positions whose logits are returned)."""
    hd = tcfg.head_dim
    sections = getattr(tcfg, "mrope_section", None)
    embed = weights("text.embed")["w"]
    xs, tables = [], []
    for seq in seqs:
        ids = torch.as_tensor(np.asarray(seq["ids"]), dtype=torch.long,
                              device=device)
        x = embed[ids].clone()
        if seq.get("image") is not None:
            # the image rows of the prompt only: a served token may carry
            # the image token's id, and is embedded as text
            at = torch.zeros_like(ids, dtype=torch.bool)
            at[:seq["prompt"]] = ids[:seq["prompt"]] == seq["image_token"]
            x[at] = seq["image"].to(x.dtype)
        xs.append(x)
        cos, sin = rope_tables(np.asarray(seq["positions"]), hd,
                               tcfg.rope_theta, sections, device)
        tables.append((cos[:, None], sin[:, None]))
    del embed
    eps = tcfg.rms_norm_eps
    for i in range(tcfg.num_hidden_layers):
        p = weights(f"text.layer.{i}")
        a, m = p["attn"], p["mlp"]
        for n, (cos, sin) in enumerate(tables):
            x = xs[n]
            t = x.shape[0]
            h = rms(x, p["ln1"]["scale"], eps)
            q = lin(a["q"], h).reshape(t, -1, hd)
            k = lin(a["k"], h).reshape(t, -1, hd)
            v = lin(a["v"], h).reshape(t, -1, hd)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
            causal = torch.ones(t, t, dtype=torch.bool, device=device).tril()
            x = x + lin(a["o"], attend(q, k, v, causal).reshape(t, -1))
            h2 = rms(x, p["ln2"]["scale"], eps)
            x = x + lin(m["down"], torch.nn.functional.silu(lin(m["gate"], h2))
                        * lin(m["up"], h2))
            xs[n] = x
        del p, a, m
    final = weights("text.final_norm")["scale"]
    head = weights("text.lm_head")["w"] if not tcfg.tie_word_embeddings \
        else weights("text.embed")["w"]
    out = []
    for seq, x in zip(seqs, xs):
        want = torch.as_tensor(np.asarray(seq["want"]), dtype=torch.long,
                               device=device)
        out.append(rms(x[want], final, eps) @ head.t())
    return out


# ── weights ─────────────────────────────────────────────────────────

def provider(draw, served: torch.dtype):
    """``weights(unit)``: the unit drawn again from the seed (``draw(name)``
    gives it in fp32), each leaf rounded to ``served`` as the configuration
    serves it and widened to fp32."""

    def convert(tree):
        if isinstance(tree, dict):
            return {k: convert(v) for k, v in tree.items()}
        return tree.to(served).float()

    return lambda name: convert(draw(name))
