"""The harness's repairs for configurations beyond the reader: the port's
configuration built from the file's ``architecture``, and the unit
wrappers chosen by name, with the OCR cells' configuration and wrappers
as they were."""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import torch

from benchmark import harness
from benchmark.drivers.common import GUIDED, UNITS, Window, instrument
from benchmark.tracing import ANCHOR, DeviceTrace, Ranges, summarize

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ROOT / "configs"


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def port_config(model: dict):
    """The port's configuration, as ``harness.run_cell`` builds it: from
    the module of the file's ``architecture``."""
    return harness.architecture(ROOT, model.get("architecture")).config(
        model["hf"])


def test_the_reader_s_configuration_is_vlconfig_from_hf_field_for_field():
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    model = config("olmocr2-7b")
    cfg, text = port_config(model)
    before = VLConfig.from_hf(model["hf"])
    assert cfg == before and text == before.text
    assert dataclasses.asdict(cfg) == dataclasses.asdict(before)
    assert text.head_dim == 128 and list(text.mrope_section) == [16, 24, 24]


def test_the_reasoner_s_configuration_keeps_its_head_dim_and_has_no_mrope():
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    cfg, text = port_config(config("qwen3-32b-int8"))
    assert isinstance(cfg, Qwen3Config) and text is cfg
    assert cfg.head_dim == 128 != cfg.hidden_size // cfg.num_attention_heads
    assert cfg.mrope_section is None
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.vocab_size) == (64, 5120, 25600, 64, 8, 151936)
    assert cfg.eos_token_id == 151645 and not cfg.tie_word_embeddings


@pytest.mark.parametrize("model", [{"architecture": "mamba", "hf": {}},
                                   {"hf": {}}])
def test_an_unknown_architecture_raises(model):
    with pytest.raises(ValueError, match="architecture"):
        port_config(model)


def fake_batcher():
    def unit(name):
        return lambda *args, **kwargs: name
    names = UNITS + GUIDED + ("verify_step", "embed_prompt")
    program = SimpleNamespace(eos_token_id=0,
                              **{name: unit(name) for name in names})
    return SimpleNamespace(program=program), names


@pytest.mark.parametrize("units", [None, GUIDED])
def test_instrument_wraps_the_units_it_is_given(units):
    """By default the read's two units, as before; with ``GUIDED`` guided
    decode's three. Nothing else is replaced, and a wrapped unit still
    returns what the program's returns."""
    batcher, names = fake_batcher()
    originals = {name: getattr(batcher.program, name) for name in names}
    window = Window(60.0, "round")
    window.open()
    kwargs = {} if units is None else {"units": units}
    instrument(batcher, window, Ranges(profile=False), None, **kwargs)
    wrapped = {name for name in names
               if getattr(batcher.program, name) is not originals[name]}
    assert wrapped == set(UNITS if units is None else GUIDED)
    for name in wrapped:
        assert getattr(batcher.program, name)() == name


def test_a_round_window_closes_where_its_driver_closes_it():
    window = Window(0.0, "round", on_due=lambda: seen.append(True))
    seen: list = []
    window.open()
    window.at_unit()                 # due: only the hook runs
    window.at_unit()
    assert seen == [True] and window.armed
    window.close()
    assert window.length >= 0 and not window.armed
    with pytest.raises(ValueError):
        Window(1.0, "turn")


class FakeEvent:
    def __init__(self, name, start, duration):
        self._name, self._start, self._duration = name, start, duration

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration


@pytest.mark.parametrize("kept", ["both", "first", "last", "none"])
def test_device_time_maps_onto_the_window_with_an_anchor_lost(kept):
    """The device's clock counts from the epoch; the host's anchors mark
    the window. With both anchor kernels the mapping is theirs; with one
    dropped by the profiler, the kernel next to it stands in."""
    epoch, ms = 1_792_000_000_000_000_000, 1_000_000
    host = [5_000 * ms, 5_100 * ms]                # a 100 ms window
    anchors = [FakeEvent(ANCHOR, epoch, 1000),
               FakeEvent(ANCHOR, epoch + 100 * ms, 1000)]
    kernels = [FakeEvent("k", epoch + (1 + 10 * i) * ms, 5 * ms)
               for i in range(10)]
    events = {"both": anchors, "first": anchors[:1], "last": anchors[1:],
              "none": []}[kept] + kernels
    trace = DeviceTrace.__new__(DeviceTrace)
    trace.anchors = host
    trace.results = type("Results", (), {"events": lambda self: events})()
    mapped = trace.events()
    assert [name for name, *_ in mapped] == ["k"] * 10
    summary = summarize(mapped, [], (host[0], host[1]))
    assert summary["busy_s"] == pytest.approx(0.05, abs=0.011)
    if kept == "both":        # to the float offset's rounding
        assert mapped[0][1] == pytest.approx(host[0] + 1 * ms, abs=1000)
