"""The plain reference against the port's plain CPU path, on tiny models
with the benchmark's own weights: the same function to float32 rounding.
And the reference's preprocessing against the port's, on a synthetic
page at the cells' size: the same pixels."""

import numpy as np
import pytest
import torch

import tiny
from benchmark import weights
from benchmark.reference import models as rm
from benchmark.reference import preprocess as rp
from benchmark.reference import tokens as rt
from benchmark.traffic.pages import synthetic_pages

CPU = torch.device("cpu")


def test_vl_reference_is_the_port_s_forward():
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    cfg = VLConfig.from_hf({**tiny.TEXT, "vision_config": tiny.VISION})
    units = weights.vl_units(cfg)
    model = VLModel(weights.assemble(units, 5, CPU, torch.float32), cfg)
    page = np.random.default_rng(1).integers(0, 255, (280, 280, 3))
    patches, grid = rp.patches(page.astype(np.uint8))
    ids = np.array(rt.ocr_prompt("read it", patches.shape[0] // 4) + [7, 8])
    port = model.forward_logits(ids[None], torch.as_tensor(patches)[None],
                                grid)[0]
    weights_of = rm.provider(
        lambda n: weights.draw_unit(units, n, 5, CPU, torch.float32),
        torch.float32)
    image = rm.vision(weights_of, cfg.vision, [(patches, grid)], CPU)[0]
    ref = rm.decoder_logits(weights_of, cfg.text, [{
        "ids": ids, "image": image, "image_token": rt.IMAGE_TOKEN,
        "prompt": len(ids), "positions": rt.mrope_positions(ids, grid, 2),
        "want": list(range(len(ids)))}], CPU)[0]
    assert float((port - ref).abs().max()) < 1e-5 * float(ref.abs().max())


def test_prompts_and_positions_are_the_port_s():
    from handwritten_ocr_tpu_torch.models.processor import (ByteTokenizer,
                                                            vlm_chat_prompt)
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import VLConfig
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
        rope_index_for_prompt)
    tok = ByteTokenizer()
    ids = rt.ocr_prompt("Extract.", 792)
    assert ids == tok.encode(vlm_chat_prompt("Extract.", 792))
    port, _ = rope_index_for_prompt(np.array(ids), VLConfig(), [(1, 66, 48)])
    assert np.array_equal(rt.mrope_positions(ids, (1, 66, 48), 2), port)
    # a served token with the image token's id is text after the prompt
    served = ids + [rt.IMAGE_TOKEN, 7]
    positions = rt.mrope_positions(served, (1, 66, 48), 2, len(ids))
    assert np.array_equal(positions[:, :len(ids)], port)
    assert (positions[:, len(ids):] == port.max() + 1 + np.arange(2)).all()


@pytest.mark.parametrize("strategy", [["deskew", "high_contrast", "binarize"],
                                      ["high_contrast", "binarize"],
                                      ["deskew"]])
def test_preprocessing_gives_the_port_s_pixels(strategy):
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchPreprocessor)
    from handwritten_ocr_tpu_torch.models.processor import pack_image_device
    page = synthetic_pages(1, 924, 672, 40, 2**31 + 11, CPU)[0]
    port = TorchPreprocessor(device=CPU).apply(page, strategy).data
    ref = rp.apply(page, strategy)
    assert np.array_equal(port.numpy(), ref)
    patches, grid = pack_image_device(port)
    ref_patches, ref_grid = rp.patches(ref)
    assert grid == ref_grid and np.array_equal(patches.numpy(), ref_patches)


def test_deskew_turns_a_tilted_page():
    page = np.full((200, 300), 230, np.uint8)
    for i in range(150):                       # a line 10 degrees off
        y, x = 50 + int(i * np.tan(np.radians(10))), 60 + i
        page[y:y + 3, x] = 20
    angle = rp.deskew_angle(page)
    assert angle is not None and abs(abs(angle) - 10) < 2
