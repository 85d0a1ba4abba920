"""Plain float32 forward pass of Qwen3 (the reasoner, qwen3:32b).

Qwen3's published decoder layer: RMSNorm, q/k/v projections without
biases, an RMSNorm over the head dim on q and on k before 1D RoPE,
grouped-query causal softmax attention (64:8 heads at head_dim 128 for
qwen3:32b), the output projection, RMSNorm and a SiLU-gated MLP; a final
RMSNorm and an untied head.

No cache, no batching, no kernels: every sequence runs whole, one layer
at a time (the weights of a layer are drawn once for all sequences and
then dropped), in float32 with TF32 off. The weights come from
``weights(unit_name)``, a float32 tree per unit
(``qwen3_weights.reference_unit``: the served int8 weights, widened).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models import attend, lin, rms, rope_tables, rotate


def logits(weights, cfg, seqs: list[dict], device) -> list[torch.Tensor]:
    """float32 logits [len(want), V] of each sequence: ``ids`` [T] (int)
    at positions 0..T-1, and ``want``, the positions whose logits are
    returned."""
    hd, eps = cfg.head_dim, cfg.rms_norm_eps
    embed = weights("text.embed")["w"]
    xs, tables = [], []
    for seq in seqs:
        ids = torch.as_tensor(np.asarray(seq["ids"]), dtype=torch.long,
                              device=device)
        xs.append(embed[ids].clone())
        cos, sin = rope_tables(np.arange(len(ids)), hd, cfg.rope_theta,
                               None, device)
        tables.append((cos[:, None], sin[:, None]))
    del embed
    for i in range(cfg.num_hidden_layers):
        p = weights(f"text.layer.{i}")
        a, m = p["attn"], p["mlp"]
        for n, (cos, sin) in enumerate(tables):
            x = xs[n]
            t = x.shape[0]
            h = rms(x, p["ln1"]["scale"], eps)
            q = rms(lin(a["q"], h).reshape(t, -1, hd), a["q_norm"]["scale"], eps)
            k = rms(lin(a["k"], h).reshape(t, -1, hd), a["k_norm"]["scale"], eps)
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
    head = weights("text.lm_head")["w"] if not cfg.tie_word_embeddings \
        else weights("text.embed")["w"]
    out = []
    for seq, x in zip(seqs, xs):
        want = torch.as_tensor(np.asarray(seq["want"]), dtype=torch.long,
                               device=device)
        out.append(rms(x[want], final, eps) @ head.t())
    return out
