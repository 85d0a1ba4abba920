"""Qwen3 text decoder: the reasoning engine's architecture.

Port of ``Qwen3Config`` and the ``Qwen3Model`` holder of
``handwritten_ocr_tpu/models/qwen3.py``. Qwen3 is a Qwen2-style GQA
decoder with an RMSNorm over the head dim on Q and K before the rotary
embedding (``q_norm``/``k_norm``), no attention biases, an explicit
``head_dim`` (qwen3:32b: 64 heads x 128 = 8192, not the hidden 5120) and
1D RoPE. It decodes through the paged stack of ``models/paged.py``
(whose QK-norm branch turns on with the ``q_norm`` params) in the
continuous batcher; the dense ``generate`` path is not ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """Defaults: qwen3:32b, the reference's reasoning model."""

    vocab_size: int = 151936
    hidden_size: int = 5120
    intermediate_size: int = 25600
    num_hidden_layers: int = 64
    num_attention_heads: int = 64
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = False
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    # 1D RoPE: position ids are [B, T] (models/qwen25vl/language.py).
    mrope_section = None

    @classmethod
    def from_hf(cls, cfg: dict) -> "Qwen3Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        eos = kwargs.get("eos_token_id", 151645)
        if isinstance(eos, list):
            eos = eos[0]
        kwargs["eos_token_id"] = 151645 if eos is None else eos
        if kwargs.get("pad_token_id") is None:
            kwargs.pop("pad_token_id", None)
        return cls(**kwargs)


class Qwen3Model:
    """Parameters (a text tree: embed / layers / final_norm / lm_head, in
    the port's layout) and their config."""

    def __init__(self, params: dict, config: Qwen3Config):
        self.params = params
        self.config = config
