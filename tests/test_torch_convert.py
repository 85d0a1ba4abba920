"""The port's conversion entry point (``python -m
handwritten_ocr_tpu_torch.cli.convert``) against the JAX package's
``scripts/convert_checkpoint.py``, both run as subprocesses on the same
tiny HF snapshots (written by the port's writer, with a tokenizer
trained in ``tests/test_torch_loading.py``): the same ``meta.json``, the
same copied snapshot files, the same size line, bit-equal parameter trees,
and the port's engines loaded from the port's checkpoint give the tokens
of JAX's engines loaded from JAX's checkpoint, in fp32 and with
``--quantize int8``."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    JaxReasoningBackend)
from handwritten_ocr_tpu.models.checkpoint import (
    load_checkpoint as jax_load_checkpoint)
from handwritten_ocr_tpu_torch.cli import convert
from handwritten_ocr_tpu_torch.engine.torch_engines import (
    TorchOCRBackend, TorchReasoningBackend)
from handwritten_ocr_tpu_torch.models.checkpoint import (PARAMS_NAME,
                                                         load_checkpoint)
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from test_torch_loading import (_equal_trees, _Spelled, _Turn,  # noqa: F401
                                snapshots, tokenizer_json)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# (family, --dtype, --quantize); tokens are compared for the fp32 cases
CASES = [("vl", "float32", None), ("vl", "float32", "int8"),
         ("vl", "bfloat16", None), ("qwen3", "float32", None),
         ("qwen3", "float32", "int8"), ("qwen3", "bfloat16", "int8")]
EXTRA = {"tokenizer_config.json": '{"model_max_length": 32768}',
         "generation_config.json": '{"do_sample": false}',
         "notes.md": "not a snapshot file"}


def _case_id(case) -> str:
    family, dtype, quantize = case
    return f"{family}-{dtype}-{quantize or 'full'}"


@pytest.fixture(scope="module")
def converted(snapshots, tmp_path_factory):
    """Every case converted by both entry points, all subprocesses
    started together: {case id: (src, port dst, jax dst, port stdout,
    jax stdout)}."""
    root, _ = snapshots
    work = tmp_path_factory.mktemp("convert")
    sources = {}
    for family in ("vl", "qwen3"):
        src = work / f"{family}_snapshot"
        shutil.copytree(root / family, src)
        for name, text in EXTRA.items():
            (src / name).write_text(text)
        sources[family] = src
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    running = {}
    for case in CASES:
        family, dtype, quantize = case
        flags = ["--dtype", dtype] + (["--quantize", quantize] if quantize
                                      else [])
        name = _case_id(case)
        commands = {
            "port": [sys.executable, "-m", "handwritten_ocr_tpu_torch.cli.convert",
                     "--device", "cpu"],
            "jax": [sys.executable, "scripts/convert_checkpoint.py"]}
        for side, command in commands.items():
            dst = work / f"{name}_{side}"
            running[name, side] = (dst, subprocess.Popen(
                [*command, family, str(sources[family]), str(dst), *flags],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    out = {}
    for (name, side), (dst, proc) in running.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name} {side}: {stderr[-3000:]}"
        out[name, side] = (dst, stdout)
    return {_case_id(case): (sources[case[0]], *out[_case_id(case), "port"],
                             *out[_case_id(case), "jax"]) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_meta_files_and_size_line_equal_jax(converted, case):
    src, port_dst, port_out, jax_dst, jax_out = converted[_case_id(case)]
    family, dtype, quantize = case
    port_meta = json.loads((port_dst / "meta.json").read_text())
    jax_meta = json.loads((jax_dst / "meta.json").read_text())
    assert port_meta == jax_meta
    assert port_meta == {"family": family, "dtype": dtype,
                         "quantize": quantize, "source": str(src),
                         "hf_config": json.loads(
                             (src / "config.json").read_text())}
    copied = sorted(p.name for p in port_dst.iterdir()
                    if p.name not in ("meta.json", PARAMS_NAME))
    assert copied == sorted(p.name for p in jax_dst.iterdir()
                            if p.name not in ("meta.json", "params"))
    assert copied == sorted(name for name in convert.SNAPSHOT_FILES
                            if (src / name).exists())
    assert "notes.md" not in copied and "tokenizer_config.json" in copied
    for name in copied:
        assert (port_dst / name).read_bytes() == (src / name).read_bytes()
    assert port_out.replace(str(port_dst), "DST") == \
        jax_out.replace(str(jax_dst), "DST")
    assert port_out.startswith(f"Saved {family} checkpoint to {port_dst} (")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_trees_equal_the_jax_checkpoint(converted, case):
    _, port_dst, _, jax_dst, _ = converted[_case_id(case)]
    params, meta = load_checkpoint(port_dst)
    jax_params, jax_meta = jax_load_checkpoint(jax_dst)
    assert meta == jax_meta
    _equal_trees(params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)))
    if case[2] == "int8":
        leaves = params["layers"] if case[0] == "qwen3" else \
            params["text"]["layers"]
        assert leaves[0]["attn"]["q"]["w_q"].dtype == torch.int8


PIXELS = dict(min_pixels=28 * 28, max_pixels=84 * 84)
TURNS = [_Turn("You are a critic.", "Check: teh cat sat"),
         _Turn("sys", "it's 12 ünïcödé <think>")]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_engines_from_the_checkpoints_give_the_jax_tokens(converted,
                                                          quantize):
    suffix = f"float32-{quantize or 'full'}"
    _, vl_port, _, vl_jax, _ = converted[f"vl-{suffix}"]
    _, q_port, _, q_jax, _ = converted[f"qwen3-{suffix}"]
    page = np.random.default_rng(6).integers(0, 256, (70, 100, 3),
                                             dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        jax_ocr = JaxOCRBackend.from_pretrained(vl_jax)
        jax_llm = JaxReasoningBackend.from_pretrained(q_jax)
        for engine in (jax_ocr, jax_llm):
            engine.tokenizer = _Spelled(engine.tokenizer)
        jax_ocr.min_pixels, jax_ocr.max_pixels = (PIXELS["min_pixels"],
                                                  PIXELS["max_pixels"])
        want = (jax_ocr.read_batch([page], "Read the page.", 6),
                jax_llm.chat_batch(TURNS, temperature=0.1, max_tokens=8))
    ocr = TorchOCRBackend.from_pretrained(vl_port, device="cpu",
                                          kv_quant=False, **PIXELS)
    llm = TorchReasoningBackend.from_pretrained(q_port, device="cpu",
                                                kv_quant=False)
    for engine in (ocr, llm):
        engine.tokenizer = _Spelled(engine.tokenizer)
    got = (ocr.read_batch([page], "Read the page.", 6),
           llm.chat_batch(TURNS, temperature=0.1, max_tokens=8))
    assert got == want
    assert all(text for texts in got for text in texts)
    assert ocr.model.params["text"]["embed"]["w"].dtype == torch.float32


def test_convert_runs_in_process_without_a_card(snapshots, tmp_path, capsys):
    """``main(argv)`` with ``--device cpu`` converts on the host; without a
    card and without ``--device`` it raises rather than fall back."""
    root, trees = snapshots
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.main(["qwen3", str(root / "qwen3"), str(tmp_path / "n")])
        assert not (tmp_path / "n").exists()
    convert.main(["qwen3", str(root / "qwen3"), str(tmp_path / "q"),
                  "--dtype", "float32", "--device", "cpu"])
    assert capsys.readouterr().out.startswith("Saved qwen3 checkpoint to ")
    params, meta = load_checkpoint(tmp_path / "q")
    _equal_trees(params, trees["qwen3"][0])
    assert meta["quantize"] is None
    with pytest.raises(SystemExit):
        convert.main(["gpt", str(root / "qwen3"), str(tmp_path / "x")])
