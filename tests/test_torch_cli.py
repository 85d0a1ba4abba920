"""The port's CLI (``python -m handwritten_ocr_tpu_torch``) against the JAX
package's (``python -m handwritten_ocr_tpu``).

Both write, per page, ``{stem}_transcription.txt``, ``{stem}_trace.json``,
``{stem}_trace_summary.txt`` and ``{stem}_eval.json``. On the ``dryrun``
backend, in single, folder, ``--skip-existing``, ``--snapshot`` and
``--lockstep`` modes, the two output folders must hold the same files
with the same bytes, apart from the wall-clock fields (each trace event's
``timestamp`` and ``elapsed_seconds``, the summary's ``[MM:SS]`` stamps),
which are masked. The same holds for one PNG page read by tiny real
engines on the same weights (the port's torch engines against the JAX
engines, weights carried across by ``from_jax_params``), and for the
standalone evaluator.
"""

import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from handwritten_ocr_tpu import config as jax_config
from handwritten_ocr_tpu.cli import eval_final as jax_eval_final
from handwritten_ocr_tpu.cli import transcribe as jax_transcribe
from handwritten_ocr_tpu_torch import config
from handwritten_ocr_tpu_torch.cli import eval_final, transcribe
from handwritten_ocr_tpu_torch.graph.driver import OCRPipeline
from test_torch_pipeline import engines  # noqa: F401  (a fixture)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _page(path: Path, seed: int, height: int = 70, width: int = 80) -> Path:
    rng = np.random.default_rng(seed)
    page = np.clip(rng.normal(235, 8, (height, width, 3)), 180, 255)
    page[20:23, 10:50] = 30
    Image.fromarray(page.astype(np.uint8)).save(path)
    return path


@pytest.fixture
def workspace(tmp_path):
    """A folder of three pages (two with ground truth, one ignored
    non-image file) and a ground-truth folder."""
    pages, gt = tmp_path / "pages", tmp_path / "gt"
    pages.mkdir()
    gt.mkdir()
    for i, name in enumerate(("b.png", "a.png", "c.PNG")):
        _page(pages / name, i)
    (pages / "notes.txt").write_text("not a page")
    (gt / "a.md").write_text("## Ground Truth\nhello world\n")
    (gt / "b.txt").write_text("dryrun transcription of b")
    return pages, gt


def _masked(path: Path) -> str:
    text = path.read_bytes().decode("utf-8")     # keeps any "\r" as it is
    if path.name.endswith("_trace.json"):
        events = json.loads(text)
        for event in events:
            event["timestamp"] = event["elapsed_seconds"] = None
        return json.dumps(events, indent=2, ensure_ascii=False)
    if path.name.endswith("_trace_summary.txt"):
        return re.sub(r"\[\d\d:\d\d\]", "[MM:SS]", text)
    return text


def _artifacts(folder: Path) -> dict:
    return {p.name: _masked(p) for p in sorted(folder.iterdir())
            if p.is_file()}


def _both(argv_for, tmp_path, pipelines=None, before=None):
    """Run the JAX CLI and the port's with ``argv_for(out_dir)``; returns
    (JAX artifacts, port artifacts)."""
    out = {}
    for name, module in (("jax", jax_transcribe), ("port", transcribe)):
        out_dir = tmp_path / f"out_{name}"
        if before:
            before(module, out_dir)
        pipeline = (pipelines[name] if pipelines else
                    module.build_pipeline("dryrun", quiet=True))
        module.main(argv_for(out_dir), pipeline=pipeline)
        out[name] = _artifacts(out_dir)
    return out["jax"], out["port"]


MODES = {
    "single": lambda pages, gt, out: [
        str(pages / "a.png"), "--ground-truth", str(gt / "a.md"),
        "--output-dir", str(out)],
    "folder": lambda pages, gt, out: [
        str(pages), "--output-dir", str(out), "--ground-truth-dir", str(gt)],
    "snapshot": lambda pages, gt, out: [
        str(pages / "b.png"), "--output-dir", str(out), "--snapshot",
        "--max-iterations", "3", "--accept-threshold", "95"],
    "lockstep": lambda pages, gt, out: [
        str(pages), "--output-dir", str(out), "--ground-truth-dir", str(gt),
        "--lockstep", "--max-iterations", "2"],
}


@pytest.mark.parametrize("quiet", [True, False], ids=["quiet", "verbose"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dryrun_artifacts_equal_the_jax_cli(workspace, tmp_path, mode, quiet,
                                            capsys):
    pages, gt = workspace
    extra = ["--quiet"] if quiet else []
    want, got = _both(lambda out: MODES[mode](pages, gt, out) + extra,
                      tmp_path)
    assert got == want
    expected = 3 if mode in ("folder", "lockstep") else 1
    assert len(got) == 4 * expected
    assert not any(name.endswith("_state.json") for name in got)
    assert "notes_transcription.txt" not in got


def test_dryrun_skip_existing_equals_the_jax_cli(workspace, tmp_path):
    """A first full run, then one page's transcription removed: the
    second run with --skip-existing redoes only that page."""
    pages, gt = workspace
    argv = lambda out: [str(pages), "--output-dir", str(out),  # noqa: E731
                        "--ground-truth-dir", str(gt), "--quiet"]

    def before(module, out_dir):
        module.main(argv(out_dir), pipeline=module.build_pipeline("dryrun"))
        (out_dir / "a_transcription.txt").unlink()
        (out_dir / "b_trace.json").write_text("[]")

    want, got = _both(lambda out: argv(out) + ["--skip-existing"], tmp_path,
                      before=before)
    assert got == want
    assert got["b_trace.json"] == "[]"          # skipped, not rewritten
    assert got["a_transcription.txt"].startswith("[dryrun transcription")


def test_eval_final_equals_the_jax_evaluator(workspace, tmp_path, capsys):
    pages, gt = workspace
    results = tmp_path / "results"
    transcribe.main([str(pages), "--output-dir", str(results), "--quiet"],
                    pipeline=transcribe.build_pipeline("dryrun"))
    outputs = {}
    for name, module in (("jax", jax_eval_final), ("port", eval_final)):
        capsys.readouterr()
        folder = tmp_path / name
        folder.mkdir()
        module.main([str(results), "--ground-truth-dir", str(gt),
                     "--output", str(folder / "all.json")])
        module.main([str(results / "a_transcription.txt"), "--ground-truth",
                     str(gt / "a.md"), "--output", str(folder / "one.json")])
        outputs[name] = (capsys.readouterr().out.replace(str(folder), ""),
                         (folder / "all.json").read_text(),
                         (folder / "one.json").read_text())
    assert outputs["port"] == outputs["jax"]
    assert len(json.loads(outputs["port"][1])) == 3


def test_real_engines_artifacts_equal_the_jax_cli(engines, tmp_path,  # noqa: F811
                                                  monkeypatch):
    """One PNG page through tiny real engines on the same weights, single
    and lockstep (two copies of the page) modes; 6 OCR and 40 agent
    tokens."""
    from handwritten_ocr_tpu.graph.driver import OCRPipeline as JaxPipeline
    path, sides = engines
    # The JAX pipelines read the budgets from the config module at call
    # time, the port's from state["config"], which its RunConfig fills.
    monkeypatch.setattr(jax_config, "OCR_MAX_NEW_TOKENS", 6)
    monkeypatch.setattr(jax_config, "LLM_MAX_TOKENS", 40)
    monkeypatch.setattr(config, "RunConfig", functools.partial(
        config.RunConfig, ocr_max_new_tokens=6, llm_max_tokens=40))
    pipelines = {
        "jax": JaxPipeline(*sides["jax"][:2], preprocessor=sides["jax"][2],
                           quiet=True),
        "port": OCRPipeline(*sides["port"][:2], preprocessor=sides["port"][2],
                            quiet=True)}
    folder = tmp_path / "pages"
    folder.mkdir()
    for name in ("p1.png", "p2.png"):
        (folder / name).write_bytes(Path(path).read_bytes())
    for argv in ([path, "--max-iterations", "2", "--quiet"],
                 [str(folder), "--lockstep", "--max-iterations", "2",
                  "--quiet"]):
        with jax.default_matmul_precision("highest"):
            want, got = _both(lambda out: argv + ["--output-dir", str(out)],
                              tmp_path, pipelines)
        assert got == want
        assert any(json.loads(got[n]) for n in got if n.endswith("_trace.json"))


def test_profile_writes_a_torch_profiler_trace(workspace, tmp_path, capsys):
    pages, gt = workspace
    trace_dir = tmp_path / "trace"
    transcribe.main([str(pages / "a.png"), "--output-dir", str(tmp_path / "o"),
                     "--profile", str(trace_dir), "--quiet"],
                    pipeline=transcribe.build_pipeline("dryrun"))
    assert list(trace_dir.glob("*.json"))
    assert f"Profiler trace saved to {trace_dir}" in capsys.readouterr().out


def test_torch_backend_without_checkpoints_names_dryrun(monkeypatch, tmp_path):
    monkeypatch.delenv("HOCR_OLMOCR_DIR", raising=False)
    monkeypatch.setenv("HOCR_QWEN3_DIR", str(tmp_path / "missing"))
    with pytest.raises(SystemExit, match="HOCR_OLMOCR_DIR and HOCR_QWEN3_DIR"
                                         r".*--backend dryrun"):
        transcribe.build_pipeline("torch")
    with pytest.raises(SystemExit, match="unknown backend"):
        transcribe.build_pipeline("jax")
    assert transcribe.build_arg_parser().parse_args(["x"]).backend == "torch"


def test_python_dash_m_runs_the_port_cli(workspace, tmp_path):
    pages, gt = workspace
    out = tmp_path / "o"
    result = subprocess.run(
        [sys.executable, "-m", "handwritten_ocr_tpu_torch", str(pages / "a.png"),
         "--backend", "dryrun", "--output-dir", str(out), "--quiet"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert sorted(p.name for p in out.iterdir()) == [
        "a_eval.json", "a_trace.json", "a_trace_summary.txt",
        "a_transcription.txt"]
