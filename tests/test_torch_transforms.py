"""The two initial strategy chains: port against the JAX ops.

A seeded paper-like uint8 page with dark strokes (as ``bench.py``'s
synthetic pages, smaller) goes through both chains on both sides.
Tolerances are those of PARITY.md for the JAX ops against OpenCV:
binarize bit-equal, CLAHE within 1 gray level, deskew within 2 levels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_ocr_tpu.ops import bank as jbank
from handwritten_ocr_tpu.ops.clahe import clahe as jax_clahe
from handwritten_ocr_tpu.ops.geometry import warp_affine_bicubic as jax_warp
from handwritten_ocr_tpu.ops.gray import rgb_to_gray as jax_gray
from handwritten_ocr_tpu.ops.threshold import (
    adaptive_threshold_gaussian as jax_threshold)
from handwritten_ocr_tpu_torch.ops import bank
from handwritten_ocr_tpu_torch.ops.clahe import clahe
from handwritten_ocr_tpu_torch.ops.geometry import (deskew_angle,
                                                    rotation_matrix,
                                                    warp_affine_bicubic)
from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
from handwritten_ocr_tpu_torch.ops.threshold import adaptive_threshold_gaussian

torch.set_num_threads(1)


def synthetic_page(height=140, width=112, seed=0, slant=0.08):
    rng = np.random.default_rng(seed)
    page = np.clip(rng.normal(235, 8, (height, width, 3)), 180, 255)
    for _ in range(12):                    # slanted pseudo text strokes
        y = int(rng.integers(15, height - 15))
        x = int(rng.integers(5, width - 50))
        length = int(rng.integers(20, 45))
        for dx in range(length):
            yy = y + int(slant * dx)
            page[yy:yy + 3, x + dx] = rng.integers(10, 60)
    return page.astype(np.uint8)


def max_diff(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def page():
    return synthetic_page()


def test_gray_is_bit_equal(page):
    np.testing.assert_array_equal(rgb_to_gray(torch.from_numpy(page)).numpy(),
                                  np.asarray(jax_gray(jnp.asarray(page))))


def test_binarize_is_bit_equal(page):
    gray = np.array(jax_gray(jnp.asarray(page)))
    np.testing.assert_array_equal(
        adaptive_threshold_gaussian(torch.from_numpy(gray)).numpy(),
        np.asarray(jax_threshold(jnp.asarray(gray))))


@pytest.mark.parametrize("shape", [(140, 112), (61, 83)])
def test_clahe_within_one_level(page, shape):
    gray = np.array(jax_gray(jnp.asarray(page)))[:shape[0], :shape[1]]
    got = clahe(torch.from_numpy(gray.copy())).numpy()
    assert max_diff(got, np.asarray(jax_clahe(jnp.asarray(gray)))) <= 1


def test_deskew_warp_within_two_levels(page):
    gray = np.array(jax_gray(jnp.asarray(page)))
    angle = deskew_angle(gray)
    assert angle is not None and angle != 0
    matrix = rotation_matrix((page.shape[1] // 2, page.shape[0] // 2), angle)
    got = warp_affine_bicubic(torch.from_numpy(page), matrix).numpy()
    assert max_diff(got, np.asarray(jax_warp(jnp.asarray(page), matrix))) <= 2


@pytest.mark.parametrize("chain", [["deskew", "high_contrast", "binarize"],
                                   ["high_contrast", "binarize"]])
def test_initial_chains(page, chain):
    got = bank.preprocess_chain(torch.from_numpy(page), chain).numpy()
    want = np.asarray(jbank.preprocess_chain(jnp.asarray(page), chain))
    assert got.shape == want.shape and got.dtype == np.uint8
    # binarize is bit-equal on equal input; a pixel may flip only where
    # the CLAHE step before it already differed by its tolerated level.
    assert (got != want).mean() <= 0.001


def test_high_contrast_chain_within_clahe_tolerance(page):
    got = bank.preprocess_chain(torch.from_numpy(page), ["deskew",
                                                         "high_contrast"])
    want = jbank.preprocess_chain(jnp.asarray(page), ["deskew",
                                                      "high_contrast"])
    assert max_diff(got.numpy(), np.asarray(want)) <= 1


def test_unported_reference_transform_raises(page):
    with pytest.raises(NotImplementedError, match="sharpen"):
        bank.preprocess_chain(torch.from_numpy(page), ["sharpen"])
    with pytest.raises(NotImplementedError):
        bank.preprocess_chain(torch.from_numpy(page), ["high_contrast",
                                                       "denoise"])


def test_unknown_name_is_skipped_and_original_is_a_no_op(page):
    image = torch.from_numpy(page)
    assert torch.equal(bank.preprocess_chain(image, ["original", "bogus"]),
                       image)
