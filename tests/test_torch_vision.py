"""Vision tower of the port against the JAX package.

``plan_grid`` must give the same arrays (including HF's padding of an
already aligned grid). ``vision_encode`` runs the tiny 3-layer tower
(two window layers, one global layer) on the same fp32 weights and
patches: the merged embeddings agree within 1e-4 (fp32 through three
layers and the merger in another summation order). JAX's CPU path
averages dead query slots uniformly where the port's flash kernel gives
0; the merger drops dead slots, so the outputs compare in full.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_tiny import configs, jax_tree, port_tree
from handwritten_ocr_tpu.models.qwen25vl.vision import (
    plan_grid as jax_plan_grid, vision_encode as jax_vision_encode)
from handwritten_ocr_tpu_torch.models.qwen25vl.vision import (plan_grid,
                                                              vision_encode)

GRIDS = [(1, 8, 12), (1, 10, 6), (1, 16, 16)]


@pytest.mark.parametrize("grid", GRIDS)
def test_plan_grid_arrays_equal(grid):
    jax_cfg, port_cfg = configs()
    want = jax_plan_grid(jax_cfg.vision, grid)
    got = plan_grid(port_cfg.vision, grid)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_plan_grid_pads_aligned_grids_like_hf():
    _, port_cfg = configs()
    plan = plan_grid(port_cfg.vision, (1, 16, 16))     # 8x8 cells: aligned
    assert plan.n_windows == 4 and plan.valid.all()


@pytest.mark.parametrize("grid", [(1, 8, 12), (1, 10, 6)])
def test_vision_encode_matches_jax(grid):
    jax_cfg, port_cfg = configs(vocab_size=300)
    tree = jax_tree(jax_cfg, seed=4)
    rng = np.random.default_rng(5)
    patches = rng.standard_normal(
        (2, grid[1] * grid[2], 3 * 2 * 14 * 14)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_vision_encode(tree["vision"], jax_cfg.vision,
                                            jnp.asarray(patches), grid))
    port = port_tree(jax.tree_util.tree_map(np.asarray, tree))
    got = vision_encode(port["vision"], port_cfg.vision,
                        torch.from_numpy(patches), grid).numpy()
    assert got.shape == want.shape == (2, grid[1] * grid[2] // 4, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
