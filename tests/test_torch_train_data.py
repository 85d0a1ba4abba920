"""The port's fine-tuning data pipeline against the JAX package's
(``handwritten_ocr_tpu/train/data.py``).

Pages are PNG files written with PIL from numpy arrays with a seed; both
sides read the same files with the byte tokenizer. Batches must be equal:
the same examples in the same order, and the same ``input_ids``,
``loss_mask``, ``position_ids``, patches and grid (patches bit-equal: the
port's PNG reader and bicubic resize are PIL-exact, and the packing is
the same fp32 arithmetic).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from handwritten_ocr_tpu.models.processor import ByteTokenizer as JaxBytes
from handwritten_ocr_tpu.train import data as jax_data
from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
from handwritten_ocr_tpu_torch.train import data

from torch_port_tiny import configs

PIXELS = dict(min_pixels=28 * 28, max_pixels=56 * 56)


def _page(path, shape, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(100, 256, (*shape, 3),
                                 dtype=np.uint8)).save(path)


@pytest.fixture()
def dataset(tmp_path):
    """Three pages of one grid and one of another; a page without ground
    truth, one whose ground truth is empty, one with a ``.txt`` beside an
    ``.md`` (the ``.md`` wins) and a file that is not an image."""
    for i, (stem, text) in enumerate((("a", "first page"),
                                      ("b", "second page words"),
                                      ("c", "third"))):
        _page(tmp_path / f"{stem}.png", (60, 80), i)
        (tmp_path / f"{stem}.md").write_text(f"## Ground Truth\n{text}\n")
    (tmp_path / "c.txt").write_text("not this one")
    _page(tmp_path / "d.png", (120, 60), 3)          # another grid
    (tmp_path / "d.txt").write_text("tall page, plain text\n")
    _page(tmp_path / "no_gt.png", (60, 80), 4)
    _page(tmp_path / "empty.png", (60, 80), 5)
    (tmp_path / "empty.md").write_text("## Ground Truth\n   \n")
    (tmp_path / "notes.md").write_text("not a page")
    return tmp_path


def _assert_batches_equal(got, want):
    (batch, grid), (jax_batch, jax_grid) = got, want
    assert grid == tuple(jax_grid)
    for name in ("input_ids", "loss_mask", "position_ids", "patches"):
        ours = getattr(batch, name)
        assert ours.device.type == "cpu"
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(getattr(jax_batch, name)),
                                      err_msg=name)


def test_discover_examples_matches_jax(dataset, tmp_path_factory):
    got = data.discover_examples(dataset)
    want = jax_data.discover_examples(dataset)
    assert [(e.image_path, e.target_text) for e in got] == \
        [(e.image_path, e.target_text) for e in want]
    assert [e.target_text for e in got] == [
        "first page", "second page words", "third", "tall page, plain text"]
    # ground truth in its own folder
    gt_dir = tmp_path_factory.mktemp("gt")
    (gt_dir / "b.md").write_text("elsewhere")
    got = data.discover_examples(dataset, gt_dir)
    assert [(e.image_path, e.target_text) for e in got] == \
        [(e.image_path, e.target_text)
         for e in jax_data.discover_examples(dataset, gt_dir)]
    assert [e.target_text for e in got] == ["elsewhere"]


@pytest.mark.parametrize("max_target_tokens", [2048, 5])
def test_build_batch_matches_jax(dataset, max_target_tokens):
    jax_cfg, cfg = configs()
    examples = data.discover_examples(dataset)[:3]
    got = data.build_batch(examples, ByteTokenizer(), cfg,
                           max_target_tokens=max_target_tokens,
                           device="cpu", **PIXELS)
    want = jax_data.build_batch(jax_data.discover_examples(dataset)[:3],
                                JaxBytes(), jax_cfg,
                                max_target_tokens=max_target_tokens, **PIXELS)
    _assert_batches_equal(got, want)
    batch = got[0]
    ids, mask = batch.input_ids.numpy(), batch.loss_mask.numpy()
    for row, text in enumerate(["first page", "second page words", "third"]):
        span = np.flatnonzero(mask[row])
        assert len(span) == min(len(text), max_target_tokens) + 1
        assert ids[row, span[-1]] == cfg.eos_token_id
        assert (ids[row, span] != cfg.image_token_id).all()
    assert (ids == cfg.image_token_id).sum() == 3 * (2 * 4 // 4)


def test_batches_by_grid_matches_jax(dataset):
    jax_cfg, cfg = configs()
    got = list(data.batches_by_grid(data.discover_examples(dataset),
                                    ByteTokenizer(), cfg, batch_size=2,
                                    device="cpu", **PIXELS))
    want = list(jax_data.batches_by_grid(
        jax_data.discover_examples(dataset), JaxBytes(), jax_cfg,
        batch_size=2, **PIXELS))
    assert [g for _, g in got] == [(1, 2, 4), (1, 2, 4), (1, 4, 2)]
    assert [b.input_ids.shape[0] for b, _ in got] == [2, 1, 1]
    assert len(got) == len(want)
    for ours, theirs in zip(got, want):
        _assert_batches_equal(ours, theirs)


def test_build_batch_refuses_mixed_grids(dataset):
    jax_cfg, cfg = configs()
    examples = data.discover_examples(dataset)
    with pytest.raises(ValueError, match="multiple grids"):
        data.build_batch(examples, ByteTokenizer(), cfg, device="cpu",
                         **PIXELS)
    with pytest.raises(ValueError, match="multiple grids"):
        jax_data.build_batch(jax_data.discover_examples(dataset), JaxBytes(),
                             jax_cfg, **PIXELS)


def test_build_batch_defaults_to_the_card(dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    _, cfg = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.build_batch(data.discover_examples(dataset)[:1],
                         ByteTokenizer(), cfg, **PIXELS)
