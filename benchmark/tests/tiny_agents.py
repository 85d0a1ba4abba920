"""A tiny copy of the agent cell for CPU tests: the same harness, driver,
reference and metric readers over a two-layer Qwen3 of small widths
(the published vocabulary, whose special ids the chat template uses) and
a round of a few turns."""

from __future__ import annotations

import json
from pathlib import Path

import tiny

BENCH = tiny.BENCH
TEXT = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0, "vocab_size": 151936,
        "tie_word_embeddings": False, "eos_token_id": 151645}
CONFIG = {"architecture": "qwen3", "hf": TEXT, "init_std": tiny.INIT_STD}


def agents_cell(**overrides) -> dict:
    cell = json.loads((BENCH / "workloads" / "agents.critic48.json")
                      .read_text())
    cell.update(turns=3, length={"median": 120, "sigma": 0.5, "min": 40,
                                 "max": 300},
                max_tokens=96, warmup={"turns": 1, "max_tokens": 30},
                sample_turns=3,
                # sound runs read a mean of 0.0003-0.001 and a widest gap
                # under 0.05 here; a step that keeps its state, 0.013
                limits={"mean_logit_gap": 0.005, "max_logit_gap": 0.25,
                        "max_choice_gap": 0.25})
    cell.update(overrides)
    return cell


def make(tmp: Path, cells: dict | None = None) -> Path:
    """tiny.make's benchmark directory with the tiny Qwen3 configuration
    beside the tiny VL one; the per-layer metrics are the agent cells'
    (those whose name ends in ``.agents``), listing ``cells``."""
    cells = cells or {"agents.tiny": ("tiny-qwen3", agents_cell())}
    path = tiny.make(tmp, cells)
    spec = json.loads(path.read_text())
    (tmp / "bench" / "configs" / "tiny-qwen3.json").write_text(
        json.dumps(CONFIG))
    spec["configs"].append({"name": "tiny-qwen3", "source": "test",
                            "reduced": [], "why": "test",
                            "file": "bench/configs/tiny-qwen3.json"})
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"].endswith(".agents")]
    path.write_text(json.dumps(spec))
    return path
