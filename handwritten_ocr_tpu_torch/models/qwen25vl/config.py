"""Qwen2.5-VL configuration dataclasses (copied from the JAX package's
``models/qwen25vl/config.py``; parsed from an HF config.json)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Sequence[int] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    tokens_per_second: int = 2
    rope_theta: float = 10000.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def spatial_merge_unit(self) -> int:
        return self.spatial_merge_size * self.spatial_merge_size

    @classmethod
    def from_hf(cls, cfg: dict) -> "VisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in cfg.items() if k in known})


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Sequence[int] = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 128000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, cfg: dict) -> "TextConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in cfg.items() if k in known}
        rope_scaling = cfg.get("rope_scaling") or {}
        if "mrope_section" in rope_scaling:
            kwargs["mrope_section"] = tuple(rope_scaling["mrope_section"])
        return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class VLConfig:
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645          # <|im_end|>
    pad_token_id: int = 151643          # <|endoftext|>

    @classmethod
    def from_hf(cls, cfg: dict) -> "VLConfig":
        eos = cfg.get("eos_token_id")
        if isinstance(eos, list):
            eos = eos[0]
        if eos is None:
            eos = 151645
        return cls(
            vision=VisionConfig.from_hf(cfg.get("vision_config", {})),
            text=TextConfig.from_hf(cfg.get("text_config", cfg)),
            image_token_id=cfg.get("image_token_id", 151655),
            video_token_id=cfg.get("video_token_id", 151656),
            vision_start_token_id=cfg.get("vision_start_token_id", 151652),
            vision_end_token_id=cfg.get("vision_end_token_id", 151653),
            eos_token_id=eos,
            pad_token_id=cfg.get("pad_token_id") or 151643,
        )

    @classmethod
    def from_pretrained_dir(cls, model_dir: str | Path) -> "VLConfig":
        cfg = json.loads((Path(model_dir) / "config.json").read_text())
        return cls.from_hf(cfg)
