"""The transforms and every strategy chain: port against the JAX ops.

A seeded paper-like uint8 page with dark strokes (as ``bench.py``'s
synthetic pages, smaller) goes through each transform and each chain of
the default strategy bank on both sides. Tolerances are those of
PARITY.md for the JAX ops against OpenCV: binarize, sharpen, the Lab
conversions and the line mask bit-equal, CLAHE within 1 gray level,
deskew within 2 levels, denoise within 1 level (gray) / 3 (colored). A
chain's tolerance follows from its last step's (below).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from handwritten_ocr_tpu.ops import bank as jbank
from handwritten_ocr_tpu.ops import colorspace as jax_colorspace
from handwritten_ocr_tpu.ops import denoise as jax_denoise
from handwritten_ocr_tpu.ops import lines as jax_lines
from handwritten_ocr_tpu.ops.clahe import clahe as jax_clahe
from handwritten_ocr_tpu.ops.filters import dilate_rect as jax_dilate
from handwritten_ocr_tpu.ops.filters import erode_rect as jax_erode
from handwritten_ocr_tpu.ops.sharpen import sharpen as jax_sharpen
from handwritten_ocr_tpu.ops.geometry import warp_affine_bicubic as jax_warp
from handwritten_ocr_tpu.ops.gray import rgb_to_gray as jax_gray
from handwritten_ocr_tpu.ops.threshold import (
    adaptive_threshold_gaussian as jax_threshold)
from handwritten_ocr_tpu_torch.config import PREPROCESSING_STRATEGIES
from handwritten_ocr_tpu_torch.ops import bank, colorspace, denoise, lines
from handwritten_ocr_tpu_torch.ops.clahe import clahe
from handwritten_ocr_tpu_torch.ops.filters import dilate_rect, erode_rect
from handwritten_ocr_tpu_torch.ops.geometry import (deskew_angle,
                                                    rotation_matrix,
                                                    warp_affine_bicubic)
from handwritten_ocr_tpu_torch.ops.gray import rgb_to_gray
from handwritten_ocr_tpu_torch.ops.sharpen import sharpen
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
    """No transform of the JAX registry is left unported (the port used
    to raise NotImplementedError for those): every name has its port and
    runs, keeping the mode the JAX transform keeps."""
    assert set(bank.TRANSFORMS) == set(jbank.TRANSFORMS)
    image = torch.from_numpy(page[:28, :28].copy())
    for name, transform in bank.TRANSFORMS.items():
        out = transform(image)
        to_gray = name in ("high_contrast", "binarize")
        assert out.shape == (image.shape[:2] if to_gray else image.shape)
        assert out.dtype == torch.uint8


@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "gray"])
def test_sharpen_is_bit_equal(page, rgb):
    image = page if rgb else np.array(jax_gray(jnp.asarray(page)))
    np.testing.assert_array_equal(sharpen(torch.from_numpy(image)).numpy(),
                                  np.asarray(jax_sharpen(jnp.asarray(image))))


def test_colorspace_is_bit_equal():
    """Both directions over a 32-step grid of every channel (32768 values)
    and a random image."""
    grid = np.stack(np.meshgrid(*[np.arange(0, 256, 8)] * 3, indexing="ij"),
                    -1).reshape(-1, 1, 3).astype(np.uint8)
    rng = np.random.default_rng(5)
    for image in (grid, rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)):
        lab = colorspace.linear_bgr_to_lab_u8(torch.from_numpy(image)).numpy()
        np.testing.assert_array_equal(lab, np.asarray(
            jax_colorspace.linear_bgr_to_lab_u8(jnp.asarray(image))))
        back = colorspace.lab_u8_to_linear_bgr(torch.from_numpy(image))
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            jax_colorspace.lab_u8_to_linear_bgr(jnp.asarray(image))))


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_denoise_within_tolerance(page, colored):
    image = page[:56, :56].copy()
    if colored:
        got = denoise.nl_means_colored(torch.from_numpy(image)).numpy()
        want = np.asarray(jax_denoise.nl_means_colored(jnp.asarray(image)))
    else:
        image = image[..., 1].copy()
        got = denoise.nl_means(torch.from_numpy(image)).numpy()
        want = np.asarray(jax_denoise.nl_means(jnp.asarray(image)))
    assert max_diff(got, want) <= (3 if colored else 1)


def lined_page(page):
    gray = np.array(jax_gray(jnp.asarray(page)))
    gray[20:22] = 40                       # two ruled lines
    gray[70:71, 10:] = 55
    return gray


def test_remove_lines_mask_bit_equal_and_inpaint_within_one_level(page):
    """The mask is bit-equal; the diffusion inpaint repeats the JAX
    package's float32 steps in order, held to 1 gray level."""
    gray = lined_page(page)
    mask = lines.line_mask(torch.from_numpy(gray)).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jax_lines.line_mask(jnp.asarray(gray))))
    assert mask[20:22].all()
    for image in (gray, page):
        got = lines.remove_lines(torch.from_numpy(image)).numpy()
        want = np.asarray(jax_lines.remove_lines(jnp.asarray(image)))
        assert max_diff(got, want) <= 1


@pytest.mark.parametrize("kw,kh", [(28, 1), (1, 3), (4, 4), (1, 1)])
def test_erode_dilate_are_bit_equal(page, kw, kh):
    gray = np.array(jax_gray(jnp.asarray(page)))
    for port_op, jax_op in ((erode_rect, jax_erode), (dilate_rect, jax_dilate)):
        np.testing.assert_array_equal(
            port_op(torch.from_numpy(gray), kw, kh).numpy(),
            np.asarray(jax_op(jnp.asarray(gray), kw, kh)))


# A chain's tolerance follows from its last step: binarize is bit-equal on
# equal input, so a pixel flips only where the CLAHE before it differed
# (<= 0.1% of pixels); a chain ending in CLAHE stays within its 1 level;
# sharpen after CLAHE moves a 1-level difference by at most the sum of
# its kernel's magnitudes (9).
LAST_STEP_TOLERANCE = {"binarize": (255, 0.001), "high_contrast": (1, 0.005),
                       "sharpen": (9, 0.01)}


@pytest.mark.parametrize("index", range(len(PREPROCESSING_STRATEGIES)))
def test_strategy_chains_match_jax(page, index):
    chain = PREPROCESSING_STRATEGIES[index]
    got = bank.preprocess_chain(torch.from_numpy(page), chain).numpy()
    want = np.asarray(jbank.preprocess_chain(jnp.asarray(page), chain))
    assert got.shape == want.shape and got.dtype == np.uint8
    level, share = LAST_STEP_TOLERANCE[chain[-1]]
    assert max_diff(got, want) <= level
    assert (got != want).mean() <= share


def test_unknown_name_is_skipped_and_original_is_a_no_op(page):
    image = torch.from_numpy(page)
    assert torch.equal(bank.preprocess_chain(image, ["original", "bogus"]),
                       image)
