"""The PyTorch port stands alone: no JAX, no JAX package, no Triton at import.

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
    return sorted(info.name for info in pkgutil.walk_packages(
        [str(PORT)], prefix="handwritten_ocr_tpu_torch."))


def test_port_has_the_slice_modules():
    modules = set(_port_modules())
    for name in ("config", "ops.dispatch", "ops.build", "ops.flash_attention",
                 "ops.window_attention", "ops.paged_decode_attention",
                 "ops.bank", "models.layers", "models.weights", "models.init",
                 "models.processor", "models.paged", "models.qwen25vl.vision",
                 "models.qwen25vl.language", "models.qwen25vl.model",
                 "engine.serving", "engine.torch_engines"):
        assert f"handwritten_ocr_tpu_torch.{name}" in modules


def test_importing_every_module_loads_no_jax_and_no_triton():
    code = (
        "import importlib, json, sys\n"
        f"names = {_port_modules()!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'triton' or m.startswith('triton.')\n"
        "             or m == 'handwritten_ocr_tpu'\n"
        "             or m.startswith('handwritten_ocr_tpu.'))\n"
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
    for needle in ("import jax", "from jax", "handwritten_ocr_tpu.",
                   "import handwritten_ocr_tpu\n"):
        assert needle not in text, f"{path} mentions {needle!r}"


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchOCRBackend(model=None, tokenizer=ByteTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchPreprocessor()
    backend = TorchOCRBackend(model=None, tokenizer=ByteTokenizer(),
                              device="cpu")
    assert backend.device.type == "cpu"


def test_version():
    assert handwritten_ocr_tpu_torch.__version__
