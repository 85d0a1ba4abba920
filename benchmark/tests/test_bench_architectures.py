"""A configuration brings its architecture as new files: the harness
finds ``architectures/<name>.py`` by name, as it finds metric readers,
and the agent driver takes the model from it, naming none itself."""

import ast
import json
import time
from pathlib import Path

import pytest
import torch

import tiny
import tiny_agents
from benchmark import harness

BENCH = tiny.BENCH
ALIAS = '''"""qwen3's architecture under another name, from this file alone."""
from pathlib import Path

from benchmark import harness

_qwen3 = harness.architecture(Path(__file__).resolve().parent.parent, "qwen3")
config, units = _qwen3.config, _qwen3.units
program, reference_logits = _qwen3.program, _qwen3.reference_logits
'''


def alias_bench(tmp: Path) -> Path:
    """A tiny benchmark whose agent cell runs on a configuration of the
    architecture ``tiny_alias``, which exists only as files added under
    ``tmp``."""
    cells = {"agents.alias": ("tiny-alias", tiny_agents.agents_cell())}
    path = tiny.make(tmp, cells)
    root = tmp / "bench"
    (root / "architectures" / "tiny_alias.py").write_text(ALIAS)
    (root / "configs" / "tiny-alias.json").write_text(json.dumps(
        {**tiny_agents.CONFIG, "architecture": "tiny_alias"}))
    spec = json.loads(path.read_text())
    spec["configs"].append({"name": "tiny-alias", "source": "test",
                            "reduced": [], "why": "test",
                            "file": "bench/configs/tiny-alias.json"})
    path.write_text(json.dumps(spec))
    return path


def test_a_cell_runs_on_an_architecture_added_as_new_files(tmp_path):
    assert not (BENCH / "architectures" / "tiny_alias.py").exists()
    spec = alias_bench(tmp_path)
    out = harness.run_cell(spec, "agents.alias", 2**31 + 5, 1.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] == 3 and out["failed"] == 0
    assert set(out["metrics"]) == {"agent_turns_per_s", "setup_s"}


def test_an_unknown_architecture_names_the_files_there(tmp_path):
    root = tmp_path / "bench"
    (root / "architectures").mkdir(parents=True)
    (root / "architectures" / "tiny_alias.py").write_text(ALIAS)
    with pytest.raises(ValueError, match=r"'mamba'.*\['tiny_alias'\]"):
        harness.architecture(root, "mamba")
    for name in ("../architectures/tiny_alias", "tiny_alias.py", None):
        with pytest.raises(ValueError, match="architecture"):
            harness.architecture(root, name)


def test_every_architecture_of_the_benchmark_gives_what_drivers_take():
    """``config`` for all; the model-neutral agent driver also takes the
    units, the program and the plain reference."""
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    neutral = {"agents"}
    for cell in spec["workloads"]:
        _, root, _, body, model = harness.cell_files(
            BENCH.parent / "BENCHMARK.json", cell["name"])
        module = harness.architecture(root, model["architecture"])
        assert callable(module.config)
        if body["driver"] in neutral:
            for name in ("units", "program", "reference_logits"):
                assert callable(getattr(module, name)), (cell["name"], name)


def imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.update(f"{node.module}.{alias.name}" for alias in node.names)
    return names


def test_the_agent_driver_names_no_model():
    """No model class of the port, no model file of the port or of the
    reference, and no model's weights by name: all come from the
    configuration's architecture."""
    path = BENCH / "drivers" / "agents.py"
    found = imports(path)
    models = {p.stem for p in (BENCH / "reference").glob("*.py")} \
        - {"__init__", "chat", "compare", "models"}
    assert models, "the reference holds a model file"
    for name in found:
        assert not name.startswith("handwritten_ocr_tpu_torch.models"), name
        assert not any(name.startswith(f"benchmark.reference.{m}")
                       or name == f"benchmark.reference.{m}"
                       for m in models), name
    source = path.read_text()
    for word in ("Qwen", "qwen", "VLConfig", "VLModel"):
        assert word not in source, word
