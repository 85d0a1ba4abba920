"""The PyTorch port stands alone: no JAX, no optax, no JAX package, no Triton
at import, and none of PIL, pydantic, safetensors, transformers, tokenizers
or regex, which the card's machine lacks.

Also checks that the port's entry points refuse to fall back to the CPU
when no card is present and no device was asked for.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import handwritten_ocr_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "handwritten_ocr_tpu_torch"


def _port_modules() -> list[str]:
    """Every module of the port but ``__main__`` (importing it runs the
    CLI)."""
    return sorted(info.name for info in pkgutil.walk_packages(
        [str(PORT)], prefix="handwritten_ocr_tpu_torch.")
        if not info.name.endswith(".__main__"))


def test_port_has_the_slice_modules():
    modules = set(_port_modules())
    for name in ("config", "ops.dispatch", "ops.build", "ops.flash_attention",
                 "ops.window_attention", "ops.paged_decode_attention",
                 "ops.int8_matmul", "ops.bank", "models.layers",
                 "models.weights", "models.init", "models.quant",
                 "models.qwen3", "models.processor", "models.paged",
                 "models.qwen25vl.vision", "models.qwen25vl.language",
                 "models.qwen25vl.model", "engine.serving",
                 "engine.torch_engines", "engine.llm_client",
                 "utils.jsonio", "utils.schema_decode", "agents.schemas",
                 "agents.schema_prompt", "agents.runners", "text.normalize",
                 "text.metrics", "text.diff", "text.merge", "text.gt",
                 "state", "trace", "graph.routing", "graph.driver",
                 "graph.batch_driver", "ops.sharpen", "ops.colorspace",
                 "ops.denoise", "ops.lines", "parallel.budget", "models.png",
                 "utils.safetensors", "models.tokenizer",
                 "models.checkpoint", "engine.dryrun", "engine.prefetch",
                 "evaluation", "cli.eval_final", "cli.transcribe",
                 "utils.json_guard", "train", "train.step", "train.data",
                 "train.optim", "parallel", "parallel.mesh",
                 "parallel.sharding", "parallel.distributed",
                 "parallel.context_parallel", "parallel.collectives",
                 "parallel.dryrun", "engine.fakes", "engine.ollama_client",
                 "engine.hf_ocr", "native", "cli.convert"):
        assert f"handwritten_ocr_tpu_torch.{name}" in modules


def test_importing_every_module_loads_no_jax_and_no_triton():
    """Nor optax, pydantic, PIL, safetensors, transformers, tokenizers or regex:
    the card's machine has none of them (PIL is imported only inside the
    function that loads a non-PNG image file). ``__main__`` runs the CLI,
    so it is left out of the import loop."""
    code = (
        "import importlib, json, sys\n"
        f"names = {_port_modules()!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "roots = ('jax', 'optax', 'triton', 'handwritten_ocr_tpu', 'pydantic',\n"
        "         'PIL', 'safetensors', 'transformers', 'tokenizers', 'regex')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "print(json.dumps(bad))\n")
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert json.loads(result.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    for needle in ("import jax", "from jax", "import optax", "from optax",
                   "handwritten_ocr_tpu.",
                   "import handwritten_ocr_tpu\n", "import safetensors",
                   "from safetensors", "import transformers",
                   "from transformers", "import tokenizers",
                   "from tokenizers", "import regex"):
        assert needle not in text, f"{path} mentions {needle!r}"


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOCRBackend(model=None, tokenizer=ByteTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPreprocessor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchReasoningBackend(model=None, tokenizer=ByteTokenizer())
    backend = TorchOCRBackend(model=None, tokenizer=ByteTokenizer(),
                              device="cpu")
    assert backend.device.type == "cpu"


def test_version():
    assert handwritten_ocr_tpu_torch.__version__
