"""The plan of ``chip_smoke.py``, checked without a card: its table of
cuts (``REDUCED``) names phases that exist, cuts depth (and the token
counts it lists) but no width, and leaves the main paths at full size.
Importing the script needs no card; running it does."""

import dataclasses
import importlib.util
import inspect
from pathlib import Path

import pytest

from handwritten_ocr_tpu_torch.models.qwen25vl.config import (TextConfig,
                                                              VLConfig,
                                                              VisionConfig)
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# what each key of a cut counts in the published configs
FULL = {"qwen3_layers": Qwen3Config().num_hidden_layers,
        "vl_text_layers": TextConfig().num_hidden_layers,
        "vl_vision_blocks": VisionConfig().depth,
        "vl_global_blocks": list(VisionConfig().fullatt_block_indexes)}
# the only fields a cut may change, per config
DEPTH_FIELDS = {TextConfig: {"num_hidden_layers"},
                VisionConfig: {"depth", "fullatt_block_indexes"},
                Qwen3Config: {"num_hidden_layers"}}


def _differing(got, want) -> set:
    """Names of the fields where two configs differ, nested configs
    followed down."""
    out = set()
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if dataclasses.is_dataclass(b):
            out |= {f"{field.name}.{n}" for n in _differing(a, b)}
        elif a != b:
            out.add(field.name)
    return out


def test_every_reduced_key_names_a_phase_function(smoke):
    assert smoke.REDUCED
    for phase in smoke.REDUCED:
        assert phase.startswith("phase_")
        assert inspect.isfunction(getattr(smoke, phase, None)), phase


def test_cuts_count_below_the_published_configs(smoke):
    """Every cut's "full" figure is the published config's (or the read
    cell's 128 tokens), and every "used" figure lies below it."""
    for phase, cuts in smoke.REDUCED.items():
        assert cuts, phase
        for what, (used, full) in cuts.items():
            if what.endswith("_tokens"):
                assert full == 128, (phase, what)
                assert 0 < used < full, (phase, what)
            elif what == "vl_global_blocks":
                assert full == FULL[what], (phase, what)
                assert used and set(used) <= set(
                    range(cuts["vl_vision_blocks"][0])), (phase, used)
            else:
                assert full == FULL[what], (phase, what)
                assert 0 < used < full, (phase, what)


@pytest.mark.parametrize("phase", [
    "phase_guided", "phase_speculative", "phase_cli", "phase_pipeline",
    "phase_dense", "phase_fp_kv", "phase_convert", "phase_tp",
    "phase_train_sharded", "phase_fsdp_serving", "phase_train_grad_check"])
def test_no_cut_touches_a_width(smoke, phase):
    """Each config a reduced phase builds equals ``VLConfig()`` /
    ``Qwen3Config()`` in every field but the depths REDUCED lists for it,
    and has exactly those depths."""
    cuts = smoke.REDUCED[phase]
    built = smoke.reduced_configs(phase)
    assert set(built) == ({"vl"} if "vl_text_layers" in cuts else set()) | (
        {"qwen3"} if "qwen3_layers" in cuts else set())
    if "qwen3" in built:
        cfg = built["qwen3"]
        assert _differing(cfg, Qwen3Config()) == {"num_hidden_layers"}
        assert cfg.num_hidden_layers == cuts["qwen3_layers"][0]
    if "vl" in built:
        cfg = built["vl"]
        assert _differing(cfg, VLConfig()) <= {
            "text.num_hidden_layers", "vision.depth",
            "vision.fullatt_block_indexes"}
        assert cfg.text.num_hidden_layers == cuts["vl_text_layers"][0]
        assert cfg.vision.depth == cuts["vl_vision_blocks"][0]
        assert list(cfg.vision.fullatt_block_indexes) == \
            cuts["vl_global_blocks"][0]
    for cfg in built.values():
        for part in ((cfg.text, cfg.vision) if hasattr(cfg, "vision")
                     else (cfg,)):
            default = type(part)()
            assert _differing(part, default) <= DEPTH_FIELDS[type(part)]


def test_main_paths_run_at_full_size(smoke):
    """The read, reasoning, train and pool_plan phases and every kernel
    phase are absent from REDUCED."""
    full_size = ["phase_main_path", "phase_reasoning", "phase_train",
                 "phase_pool_plan"] + [
        name for name in dir(smoke) if name.startswith("phase_kernels")]
    assert len(full_size) > 4
    for phase in full_size:
        assert inspect.isfunction(getattr(smoke, phase)), phase
        assert phase not in smoke.REDUCED, phase


def test_depth_cut_shares_the_resident_tensors(smoke):
    """A depth-cut tree holds the first layers and blocks of the resident
    one, the same tensor objects: no weight is copied or drawn again."""
    import torch
    layer = {"w": torch.zeros(2)}
    params = {"vision": {"patch_embed": {"w": torch.zeros(1)},
                         "blocks": [dict(layer) for _ in range(32)]},
              "text": {"embed": {"w": torch.zeros(1)},
                       "layers": [dict(layer) for _ in range(28)]}}
    cfg = smoke.reduced_configs("phase_cli")["vl"]
    cut = smoke.depth_cut(params, cfg)
    assert len(cut["vision"]["blocks"]) == cfg.vision.depth
    assert len(cut["text"]["layers"]) == cfg.text.num_hidden_layers
    assert all(a is b for a, b in zip(cut["text"]["layers"],
                                      params["text"]["layers"]))
    assert cut["text"]["embed"] is params["text"]["embed"]
    assert cut["vision"]["patch_embed"] is params["vision"]["patch_embed"]
    q = {"embed": {}, "layers": list(range(64)), "final_norm": {}}
    qcfg = smoke.reduced_configs("phase_guided")["qwen3"]
    assert smoke.depth_cut(q, qcfg)["layers"] == list(range(16))
