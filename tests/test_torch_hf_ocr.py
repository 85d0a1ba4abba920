"""The port's parity-mode OCR pieces (``engine/hf_ocr.py``) against the
JAX package's: ``FilePreprocessor``'s temp files (name, suffix, pixels,
passthrough), the device rule, the ImportError that names transformers,
and ``HFTorchOCRBackend`` reading a snapshot the port wrote with
transformers' Qwen2.5-VL model, token for token against
``TorchOCRBackend(device="cpu")``.

transformers' Qwen2.5-VL processor does not load on this machine: its
video half needs torchvision, which is not installed. The read therefore
goes through a stand-in processor that packs the page and writes the
prompt ids with the port's own pieces (``pack_image``, the snapshot's
tokenizer); the model, ``generate`` and the new-token slicing are
transformers' and the backend's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from handwritten_ocr_tpu.engine.hf_ocr import (
    FilePreprocessor as JaxFilePreprocessor)
from handwritten_ocr_tpu_torch.engine.hf_ocr import (FilePreprocessor,
                                                     HFTorchOCRBackend,
                                                     save_image)
from handwritten_ocr_tpu_torch.engine.torch_engines import TorchOCRBackend
from handwritten_ocr_tpu_torch.models import png
from handwritten_ocr_tpu_torch.models.processor import (load_image_rgb,
                                                        pack_image)
from test_torch_loading import (_Spelled, snapshots,  # noqa: F401
                                tokenizer_json)
from test_torch_transforms import synthetic_page

torch.set_num_threads(1)

PIXELS = dict(min_pixels=28 * 28, max_pixels=84 * 84)


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HFTorchOCRBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilePreprocessor()
    assert HFTorchOCRBackend(device="cpu").device.type == "cpu"
    assert FilePreprocessor(device="cpu").device.type == "cpu"


def test_first_read_names_transformers_when_it_is_missing(monkeypatch,
                                                          tmp_path):
    monkeypatch.setitem(sys.modules, "transformers", None)
    backend = HFTorchOCRBackend(device="cpu")       # nothing loads yet
    with pytest.raises(ImportError, match="transformers"):
        backend.read(str(tmp_path / "page.png"), "Read.", 4)
    with pytest.raises(ImportError, match="transformers"):
        backend.read_batch([str(tmp_path / "page.png")], "Read.", 4)
    backend.release()                                # nothing to free


@pytest.fixture(scope="module")
def page_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("page") / "page.png"
    Image.fromarray(synthetic_page()).save(path)
    return path


def _pixels(path) -> np.ndarray:
    with Image.open(path) as img:
        return np.asarray(img)


@pytest.mark.parametrize("chain", [["deskew", "high_contrast", "binarize"],
                                   ["high_contrast", "binarize"],
                                   ["sharpen"], "deskew"])
def test_file_preprocessor_writes_the_jax_files(page_png, chain, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    got = FilePreprocessor(device="cpu").apply(str(page_png), chain)
    want = JaxFilePreprocessor().apply(str(page_png), chain)
    label = "+".join(chain) if isinstance(chain, list) else chain
    for prepared in (got, want):
        assert prepared.strategy_label == label
        assert prepared.source_path == str(page_png)
        name = Path(prepared.data).name
        assert name.startswith(f"ocr_{label}_") and name.endswith(".png")
        assert Path(prepared.data).parent == tmp_path
    assert png.read_png(got.data).shape[:2] == _pixels(got.data).shape[:2]
    a, b = _pixels(got.data), _pixels(want.data)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    if "binarize" in chain:
        # a pixel may flip only where CLAHE already differed by its
        # tolerated level (tests/test_torch_transforms.py)
        assert (a != b).mean() <= 0.001
    else:
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


@pytest.mark.parametrize("chain", ["original", [], ["original"]])
def test_passthrough_equals_jax(page_png, chain):
    got = FilePreprocessor(device="cpu").apply(str(page_png), chain)
    want = JaxFilePreprocessor().apply(str(page_png), chain)
    assert (got.data, got.strategy_label, got.source_path) == \
        (want.data, want.strategy_label, want.source_path) == \
        (str(page_png), got.strategy_label, str(page_png))


def test_other_suffixes_go_through_pil(page_png, tmp_path, monkeypatch):
    source = tmp_path / "page.bmp"
    Image.open(page_png).save(source)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    got = FilePreprocessor(device="cpu").apply(str(source), ["sharpen"])
    want = JaxFilePreprocessor().apply(str(source), ["sharpen"])
    assert got.data.endswith(".bmp") and want.data.endswith(".bmp")
    np.testing.assert_array_equal(_pixels(got.data), _pixels(want.data))
    monkeypatch.setitem(sys.modules, "PIL", None)
    gray = np.zeros((4, 5), np.uint8)
    with pytest.raises(ValueError, match="PIL"):
        save_image(tmp_path / "x.jpg", gray)
    save_image(tmp_path / "x.png", gray)            # PNG needs no PIL
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png")[..., 0],
                                  gray)


def _wants_mm_token_types() -> bool:
    """Whether this transformers' Qwen2.5-VL takes ``mm_token_type_ids``."""
    import inspect

    from transformers.models.qwen2_5_vl import modeling_qwen2_5_vl
    return "mm_token_type_ids" in inspect.signature(
        modeling_qwen2_5_vl.Qwen2_5_VLModel.get_rope_index).parameters


class _PortProcessor:
    """Stands in for transformers' Qwen2.5-VL processor (see the module
    docstring): the chat template's ids and the packed patches of the
    page a message names, as a ``BatchFeature``; ``decode`` spells ids."""

    def __init__(self, engine, min_pixels, max_pixels):
        self.engine = engine
        self.pixels = dict(min_pixels=min_pixels, max_pixels=max_pixels)
        self.mm_token_types = _wants_mm_token_types()

    def apply_chat_template(self, messages, *, add_generation_prompt,
                            tokenize, return_dict, return_tensors):
        from transformers import BatchFeature
        assert add_generation_prompt and tokenize and return_dict
        assert return_tensors == "pt"
        (message,) = messages
        image, text = message["content"]
        assert message["role"] == "user" and image["type"] == "image"
        packed = pack_image(load_image_rgb(image["url"]), **self.pixels)
        ids = self.engine._prompt_ids(text["text"], packed.num_llm_tokens)
        feature = {
            "input_ids": torch.tensor(ids[None].astype(np.int64)),
            "attention_mask": torch.ones(1, len(ids), dtype=torch.long),
            "pixel_values": torch.from_numpy(packed.patches),
            "image_grid_thw": torch.tensor([packed.grid])}
        if self.mm_token_types:
            # transformers 5 places the image's M-RoPE ids by these (1 at
            # the image tokens), which its own processor returns
            feature["mm_token_type_ids"] = (
                feature["input_ids"] == self.engine.model.config.image_token_id
            ).to(torch.int32)
        return BatchFeature(feature)

    def decode(self, ids, skip_special_tokens):
        assert skip_special_tokens
        return " ".join(str(int(i)) for i in ids)


def test_hf_backend_reads_the_port_snapshot_as_the_port(snapshots, page_png,
                                                        monkeypatch, capsys):
    import transformers
    root, _ = snapshots
    port = TorchOCRBackend.from_pretrained(root / "vl", dtype=torch.float32,
                                           device="cpu", kv_quant=False,
                                           **PIXELS)
    port.tokenizer = _Spelled(port.tokenizer)
    loads = []

    def processor(model_id, **kwargs):
        loads.append((model_id, kwargs))
        return _PortProcessor(port, **kwargs)
    monkeypatch.setattr(transformers.AutoProcessor, "from_pretrained",
                        processor)
    # the backend loads in bf16, as JAX's does; the comparison is in fp32
    model_loader = transformers.AutoModelForImageTextToText.from_pretrained
    model_kwargs = []

    def model(model_id, **kwargs):
        model_kwargs.append(dict(kwargs))
        return model_loader(model_id, **(kwargs | {"torch_dtype":
                                                   torch.float32}))
    monkeypatch.setattr(transformers.AutoModelForImageTextToText,
                        "from_pretrained", model)
    backend = HFTorchOCRBackend(model_id=str(root / "vl"), device="cpu",
                                **PIXELS)
    prompt, budget = "Read the page.", 6
    got = backend.read_batch([str(page_png), str(page_png)], prompt, budget)
    assert loads == [(str(root / "vl"), PIXELS)]          # loaded once
    assert model_kwargs == [{"torch_dtype": torch.bfloat16}]
    assert backend._model.dtype == torch.float32
    want = port.read_batch([load_image_rgb(page_png)], prompt, budget)[0]
    eos = str(port.model.config.eos_token_id)
    assert [text.removesuffix(" " + eos) for text in got] == [want, want]
    assert len(want.split()) == budget
    backend.release()
    assert backend._model is None and backend._processor is None
    assert "Model unloaded" in capsys.readouterr().out
