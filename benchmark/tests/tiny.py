"""A tiny copy of the benchmark for CPU tests: the same harness, drivers,
architectures, reference and metric readers, over small models and
small traffic in a temporary directory with its own BENCHMARK.json."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent

# 0.02 x sqrt(3584) / sqrt(64): attention and MLPs weigh in the residual
# stream as much as at the published widths.
INIT_STD = 0.15
VISION = {"depth": 2, "hidden_size": 32, "intermediate_size": 64,
          "num_heads": 2, "out_hidden_size": 64, "patch_size": 14,
          "spatial_merge_size": 2, "temporal_patch_size": 2,
          "window_size": 112, "fullatt_block_indexes": [1]}
TEXT = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
        "rope_scaling": {"type": "mrope", "mrope_section": [2, 3, 3]},
        "vocab_size": 152064, "tie_word_embeddings": False,
        "eos_token_id": 151645}


def ocr_cell(**overrides) -> dict:
    cell = json.loads((BENCH / "workloads" / "ocr.notebook48.json").read_text())
    cell.update(folders=1, pages=2, height=280, width=280, strokes=6,
                close_at="folder",
                budget={"median": 4, "sigma": 0.5, "min": 2, "max": 6},
                sample_reads=4, limits={"max_logit_gap": 0.25, "mean_logit_gap": 0.01})
    cell.update(overrides)
    return cell


def make(tmp: Path, cells: dict | None = None) -> Path:
    """A benchmark directory under ``tmp`` with BENCHMARK.json listing the
    real metrics and the tiny cells ``cells`` (name -> (config, cell));
    returns the spec's path."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    root = tmp / "bench"
    for sub in ("configs", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", root / "metrics")
    shutil.copytree(BENCH / "architectures", root / "architectures")
    configs = {
        "tiny-vl": {"architecture": "qwen2_5_vl",
                    "hf": {**TEXT, "vision_config": VISION},
                    "serving": {"weights": "bfloat16"}, "init_std": INIT_STD},
    }
    for name, body in configs.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(body))
    cells = cells or {"ocr.tiny": ("tiny-vl", ocr_cell())}
    spec["paths"] = ["bench"]
    spec["configs"] = [{"name": n, "source": "test", "reduced": [],
                        "file": f"bench/configs/{n}.json", "why": "test"}
                       for n in configs]
    spec["workloads"] = []
    for name, (config, cell) in cells.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": name, "chips": 1, "why": "test"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = list(cells)
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path
