"""The slice end to end: ``TorchOCRBackend.read_batch`` against
``JaxOCRBackend.read_batch``.

Two rendered pages of different sizes (two grid groups) x the two initial
strategies, each side with its own preprocessor, tiny fp32 weights drawn
by JAX and carried over. The tokenizer is ``ByteTokenizer`` with a decode
that spells every id, so the strings carry the whole greedy token stream;
they must be equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from torch_port_tiny import configs, jax_tree, port_tree
from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    TPUPreprocessor)
from handwritten_ocr_tpu.models.qwen25vl.model import VLModel as JaxVLModel
from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
from handwritten_ocr_tpu_torch.engine.torch_engines import (TorchOCRBackend,
                                                            TorchPreprocessor)
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel

PIXELS = dict(min_pixels=28 * 28, max_pixels=112 * 112)


class SpellingTokenizer(ByteTokenizer):
    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def render_page(path, height, width, seed):
    rng = np.random.default_rng(seed)
    page = np.clip(rng.normal(235, 8, (height, width, 3)), 180, 255)
    for _ in range(8):
        y = int(rng.integers(5, height - 8))
        x = int(rng.integers(2, width - 30))
        page[y:y + 3, x:x + int(rng.integers(15, 28))] = rng.integers(10, 60)
    Image.fromarray(page.astype(np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def pages(tmp_path_factory):
    root = tmp_path_factory.mktemp("pages")
    return [render_page(root / "a.png", 60, 80, 0),
            render_page(root / "b.png", 90, 70, 1)]


def test_read_batch_matches_jax(pages):
    strategies = PREPROCESSING_STRATEGIES[:2]
    jax_cfg, port_cfg = configs()
    tree = jax_tree(jax_cfg, seed=12)
    tokenizer = SpellingTokenizer()
    with jax.default_matmul_precision("highest"):
        jax_prep = TPUPreprocessor(**PIXELS)
        jax_images = [jax_prep.apply(p, s) for p in pages for s in strategies]
        want = JaxOCRBackend(JaxVLModel(tree, jax_cfg), tokenizer,
                             **PIXELS).read_batch(jax_images, "Read.", 6)

    model = VLModel(port_tree(jax.tree_util.tree_map(np.asarray, tree)),
                    port_cfg)
    prep = TorchPreprocessor(device="cpu", **PIXELS)
    images = [prep.apply(p, s) for p in pages for s in strategies]
    assert [im.strategy_label for im in images] == \
        [im.strategy_label for im in jax_images]
    backend = TorchOCRBackend(model, tokenizer, device="cpu", **PIXELS)
    got = backend.read_batch(images, "Read.", 6)
    assert got == want
    assert all(len(text.split()) >= 1 for text in got)
    assert backend.read(images[0], "Read.", 6) == got[0]


def test_unaligned_image_is_refused():
    _, port_cfg = configs(vocab_size=300)
    backend = TorchOCRBackend(VLModel({}, port_cfg), ByteTokenizer(),
                              device="cpu")
    with pytest.raises(ValueError, match="28-aligned"):
        backend.read_batch([torch.zeros((30, 56), dtype=torch.uint8)], "x", 2)
