"""Device-memory budget of the co-resident deployment.

Port of ``handwritten_ocr_tpu/parallel/budget.py``: the same byte
arithmetic (parameters and int8 KV caches from the configs, the per-chip
``ServingPlan``), the same results for the same arguments. The JAX
package plans 8 v5e chips; the port's call site
(``engine/torch_engines.py:plan_pools``) plans one card: ``n_chips=1``,
the card's memory, each engine's resident weights (``tree_bytes``)
instead of the configs' figures, and ``config.ACTIVATION_RESERVE_BYTES``.
Its two KV components are the pool budgets the engines size their
``ContinuousBatcher`` from.

Quantisation layout as ``models/quant.py``: projections and the lm_head
int8 + an fp32 scale per output channel; embeddings, norms and biases
bf16. KV caches as ``models/paged.py``'s int8 mode (an fp32 scale per
token and head).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

_BF16 = 2
_F32 = 4
_INT8 = 1
_SAME = object()          # a model's quantisation defaults to ``quant``


def _linear_bytes(d_in: int, d_out: int, quant: bool, bias: bool = False) -> int:
    if quant:
        total = d_in * d_out * _INT8 + d_out * _F32    # w_q + w_scale
    else:
        total = d_in * d_out * _BF16
    if bias:
        total += d_out * _BF16
    return total


def qwen3_param_bytes(cfg, quant: str | None = "int8") -> int:
    """Parameter bytes of a Qwen3 decoder (QK-norm, no attention biases)."""
    q = quant == "int8"
    h, hd = cfg.hidden_size, cfg.head_dim
    nh, kv = cfg.num_attention_heads, cfg.num_key_value_heads
    inter = cfg.intermediate_size
    per_layer = (
        _linear_bytes(h, nh * hd, q)          # q
        + 2 * _linear_bytes(h, kv * hd, q)    # k, v
        + _linear_bytes(nh * hd, h, q)        # o
        + 2 * _linear_bytes(h, inter, q)      # gate, up
        + _linear_bytes(inter, h, q)          # down
        + 2 * hd * _BF16                      # q_norm, k_norm
        + 2 * h * _BF16                       # ln1, ln2
    )
    total = cfg.num_hidden_layers * per_layer
    total += cfg.vocab_size * h * _BF16       # embed (never quantised)
    total += h * _BF16                        # final_norm
    if not cfg.tie_word_embeddings:
        total += _linear_bytes(h, cfg.vocab_size, q)   # lm_head
    return total


def vl_param_bytes(cfg, quant: str | None = "int8") -> int:
    """Parameter bytes of Qwen2.5-VL (vision tower + text decoder,
    attention biases, no QK-norm)."""
    q = quant == "int8"
    v = cfg.vision
    t = cfg.text
    patch_dim = (v.in_channels * v.temporal_patch_size
                 * v.patch_size * v.patch_size)
    vision = v.hidden_size * patch_dim * _BF16          # patch_embed (bf16)
    per_block = (
        _linear_bytes(v.hidden_size, 3 * v.hidden_size, q, bias=True)  # qkv
        + _linear_bytes(v.hidden_size, v.hidden_size, q, bias=True)    # proj
        + _linear_bytes(v.hidden_size, v.intermediate_size, q, bias=True) * 2
        + _linear_bytes(v.intermediate_size, v.hidden_size, q, bias=True)
        + 2 * v.hidden_size * _BF16                                    # norms
    )
    vision += v.depth * per_block
    merge_dim = v.hidden_size * v.spatial_merge_size ** 2
    vision += (_linear_bytes(merge_dim, merge_dim, q, bias=True)       # fc1
               + _linear_bytes(merge_dim, v.out_hidden_size, q, bias=True)
               + v.hidden_size * _BF16)                                # merger ln
    h, hd = t.hidden_size, t.head_dim
    per_layer = (
        _linear_bytes(h, t.num_attention_heads * hd, q, bias=True)
        + 2 * _linear_bytes(h, t.num_key_value_heads * hd, q, bias=True)
        + _linear_bytes(t.num_attention_heads * hd, h, q)
        + 2 * _linear_bytes(h, t.intermediate_size, q)
        + _linear_bytes(t.intermediate_size, h, q)
        + 2 * h * _BF16
    )
    text = t.num_hidden_layers * per_layer
    text += t.vocab_size * h * _BF16                    # embed
    text += h * _BF16                                   # final_norm
    if not t.tie_word_embeddings:
        text += _linear_bytes(h, t.vocab_size, q)       # lm_head
    return vision + text


def kv_cache_bytes(num_layers: int, batch: int, max_len: int,
                   kv_heads: int, head_dim: int, dtype_bytes: int = _BF16,
                   kv_quant: bool = False) -> int:
    """k + v buffers of one preallocated (or fully paged) cache.
    ``kv_quant``: int8 data + an fp32 scale per token and head."""
    per_elem = (_INT8 + _F32 / head_dim) if kv_quant else dtype_bytes
    return int(2 * num_layers * batch * max_len * kv_heads * head_dim
               * per_elem)


@dataclass
class ServingPlan:
    """Per-chip memory plan of the co-resident two-engine deployment."""

    n_chips: int
    hbm_per_chip: int
    components: dict[str, int]       # name -> per-chip bytes

    @property
    def total_per_chip(self) -> int:
        return sum(self.components.values())

    @property
    def fits(self) -> bool:
        return self.total_per_chip <= self.hbm_per_chip

    def component(self, prefix: str) -> int:
        """Bytes of the one component whose name starts with ``prefix``
        (``"vl_kv"``, ``"llm_kv"``, ...)."""
        [nbytes] = [n for name, n in self.components.items()
                    if name.startswith(prefix)]
        return nbytes

    def report(self) -> str:
        lines = [f"serving plan: {self.n_chips} chips x "
                 f"{self.hbm_per_chip / 2**30:.1f} GiB HBM"]
        for name, nbytes in self.components.items():
            lines.append(f"  {name:<28s} {nbytes / 2**30:7.2f} GiB/chip")
        lines.append(f"  {'TOTAL':<28s} {self.total_per_chip / 2**30:7.2f} "
                     f"GiB/chip ({'FITS' if self.fits else 'OVER BUDGET'})")
        return "\n".join(lines)


def coresident_plan(
    vl_cfg,
    llm_cfg,
    *,
    n_chips: int = 8,
    hbm_per_chip: int = 16 * 2**30,     # v5e
    vl_tp: int | None = None,
    llm_tp: int | None = None,
    ocr_batch: int = 24,
    ocr_ctx: int = 4096,                # ~1Mpx page tokens + prompt + 2048 new
    llm_batch: int = 8,
    llm_ctx: int = 16384,               # editor/arbitrator prompts + 4096 new
    quant: str | None = "int8",
    activation_reserve: int = 2 * 2**30,
    vl_quant: Any = _SAME,
    llm_quant: Any = _SAME,
    vl_weight_bytes: int | None = None,
    llm_weight_bytes: int | None = None,
) -> ServingPlan:
    """Per-chip plan of the 7B VLM + the 32B LLM co-resident.

    TP degree defaults: the largest power of two <= min(kv_heads, n_chips)
    per model. ``vl_quant`` / ``llm_quant`` (default: ``quant``) name each
    model's weights; ``vl_weight_bytes`` / ``llm_weight_bytes`` replace the
    configs' figures with the bytes of resident weights (``tree_bytes``).
    """
    def _auto_tp(kv_heads: int) -> int:
        tp = 1
        while tp * 2 <= min(kv_heads, n_chips):
            tp *= 2
        return tp

    vl_quant = quant if vl_quant is _SAME else vl_quant
    llm_quant = quant if llm_quant is _SAME else llm_quant
    vl_tp = vl_tp or _auto_tp(vl_cfg.text.num_key_value_heads)
    llm_tp = llm_tp or _auto_tp(llm_cfg.num_key_value_heads)
    if vl_weight_bytes is None:
        vl_weight_bytes = vl_param_bytes(vl_cfg, vl_quant)
    if llm_weight_bytes is None:
        llm_weight_bytes = qwen3_param_bytes(llm_cfg, llm_quant)

    components = {
        f"vl_params[{vl_quant or 'bf16'}] TP{vl_tp}":
            vl_weight_bytes // vl_tp,
        f"llm_params[{llm_quant or 'bf16'}] TP{llm_tp}":
            llm_weight_bytes // llm_tp,
        f"vl_kv[int8] b{ocr_batch}x{ocr_ctx}":
            kv_cache_bytes(vl_cfg.text.num_hidden_layers, ocr_batch, ocr_ctx,
                           vl_cfg.text.num_key_value_heads,
                           vl_cfg.text.head_dim, kv_quant=True) // vl_tp,
        f"llm_kv[int8] b{llm_batch}x{llm_ctx}":
            kv_cache_bytes(llm_cfg.num_hidden_layers, llm_batch, llm_ctx,
                           llm_cfg.num_key_value_heads,
                           llm_cfg.head_dim, kv_quant=True) // llm_tp,
        "activations+workspace": activation_reserve,
    }
    return ServingPlan(n_chips=n_chips, hbm_per_chip=hbm_per_chip,
                       components=components)


def tree_bytes(params: Any) -> int:
    """Bytes of a materialised parameter tree (dicts and lists of tensors)."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    return params.numel() * params.element_size()
