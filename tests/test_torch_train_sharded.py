"""The port's sharded training step against the JAX package's.

JAX's ``make_train_step`` runs in this process on its virtual CPU mesh,
its parameters placed by ``shard_params(mesh, params, fsdp=...)`` and the
batch split over "data" by ``data_sharding``, as ``dryrun_multichip``
places them. The port runs the same step in spawned gloo groups, one
process per rank (``tests/torch_port_dist.py:train_cases``; the children
import no JAX and get numpy inputs), at (data, model) = (1, 2), (2, 1)
with FSDP and (2, 2) with FSDP.

The model is the tiny fp32 VL of ``torch_port_dist`` (``VISION`` /
``TEXT``, vocabulary 512) with JAX's weights (norms and biases
perturbed), and the global batch has 4 rows whose target counts differ,
and differ between the data ranks' halves (11 and 15), so a loss that
averaged the ranks' own means would show.

Tolerances, fp32 on both sides: losses, gradients and every updated
parameter after one and after two AdamW steps 2e-4 absolute and relative,
the bound of ``tests/test_torch_train.py`` on one device.

The port's ``dryrun_multichip`` runs at 8 ranks, JAX's (2, 4) mesh.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from handwritten_ocr_tpu.models.qwen25vl.config import (
    TextConfig as JaxTextConfig, VLConfig as JaxVLConfig,
    VisionConfig as JaxVisionConfig)
from handwritten_ocr_tpu.models.qwen25vl.model import rope_index_for_prompt
from handwritten_ocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from handwritten_ocr_tpu.parallel.sharding import (
    data_sharding as jax_data_sharding, shard_params as jax_shard_params)
from handwritten_ocr_tpu.train import step as jax_step
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from handwritten_ocr_tpu_torch.parallel.sharding import shard_params
from handwritten_ocr_tpu_torch.train import optim
from torch_port_dist import (IDS, TEXT, VISION, VL_IDS, Group, RankMesh,
                             dryrun_case, train_cases)
from torch_port_tiny import jax_tree

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
LR = 3e-3
GRID = (1, 4, 4)
TARGETS = (2, 9, 5, 10)           # per row: 11 on data rank 0, 15 on 1
CASES = {"tp_1x2": (1, 2, False), "fsdp_2x1": (2, 1, True),
         "fsdp_2x2": (2, 2, True)}
DRYRUN_RANKS = 8


def _batch() -> dict:
    """The global batch as numpy: [4, 20] ids (image span, then up to 10
    target tokens, pad 0 after a row's targets), patches, M-RoPE
    positions [3, 4, 20] and the loss mask."""
    rng = np.random.default_rng(11)
    n_image = GRID[1] * GRID[2] // 4
    prompt = ([1, 2, IDS["<|vision_start|>"]] + [IDS["<|image_pad|>"]] * n_image
              + [IDS["<|vision_end|>"], 3, 4])
    longest = max(TARGETS)
    ids = np.zeros((len(TARGETS), len(prompt) + longest), np.int64)
    mask = np.zeros(ids.shape, np.float32)
    for row, n in enumerate(TARGETS):
        ids[row, :len(prompt)] = prompt
        ids[row, len(prompt):len(prompt) + n] = rng.integers(5, 250, n)
        mask[row, len(prompt):len(prompt) + n] = 1.0
    positions, _ = rope_index_for_prompt(ids[0], _jax_config(), [GRID])
    positions = np.ascontiguousarray(
        np.broadcast_to(positions[:, None], (3, *ids.shape)))
    patches = rng.standard_normal(
        (len(TARGETS), GRID[0] * GRID[1] * GRID[2], 3 * 2 * 14 * 14)
    ).astype(np.float32)
    return {"input_ids": ids, "patches": patches, "position_ids": positions,
            "loss_mask": mask}


def _jax_config():
    return JaxVLConfig(vision=JaxVisionConfig(**VISION),
                       text=JaxTextConfig(**TEXT), **VL_IDS)


def _jax_batch(batch: dict, mesh=None) -> jax_step.TrainBatch:
    def put(name, ndim, axis=0):
        array = jnp.asarray(batch[name])
        if name == "input_ids":
            array = array.astype(jnp.int32)
        if mesh is None:
            return array
        return jax.device_put(array, jax_data_sharding(mesh, ndim, axis))

    return jax_step.TrainBatch(input_ids=put("input_ids", 2),
                               patches=put("patches", 3),
                               position_ids=put("position_ids", 3, 1),
                               loss_mask=put("loss_mask", 2))


def _jax_steps(params: dict, batch: dict, data: int, model: int,
               fsdp: bool) -> dict:
    """Two steps of JAX's ``make_train_step`` on its (data, model) mesh."""
    cfg = _jax_config()
    mesh = jax_make_mesh(data * model, model_parallel=model)
    out = {}
    with mesh:
        placed = jax_shard_params(mesh, jax.tree.map(jnp.asarray, params),
                                  fsdp=fsdp)
        init, train_step = jax_step.make_train_step(cfg, GRID,
                                                    optimizer=optax.adamw(LR))
        state = init(placed)
        sharded = _jax_batch(batch, mesh)
        for i in (1, 2):
            placed, state, loss = train_step(placed, state, sharded)
            out[f"loss{i}"] = float(loss)
            out[f"params{i}"] = jax.tree.map(np.array, placed)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's unsharded loss and gradients, {case: JAX's sharded steps},
    {case: every rank's results}, the dry run's ranks' summaries)."""
    params = jax.tree.map(np.asarray, jax_tree(_jax_config(), seed=5))
    batch = _batch()
    path = tmp_path_factory.mktemp("train_sharded") / "inputs.pkl"
    path.write_bytes(pickle.dumps({"params": params, "batch": batch,
                                   "grid": GRID, "lr": LR}))
    groups = {name: Group(data * model, train_cases, model, fsdp, str(path))
              for name, (data, model, fsdp) in CASES.items()}
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(jax_step.next_token_loss)(
            params, _jax_config(), _jax_batch(batch), GRID)
        want = {name: _jax_steps(params, batch, *case)
                for name, case in CASES.items()}
    results = {name: group.results(timeout=400)
               for name, group in groups.items()}
    dryrun = Group(DRYRUN_RANKS, dryrun_case).results(timeout=400)
    return ((float(loss), jax.tree.map(np.array, grads)), want, results,
            dryrun)


def _slices(tree, case: str, data_rank: int, model_rank: int) -> list:
    """The leaves a rank holds of a JAX-layout numpy tree."""
    data, model, fsdp = CASES[case]
    port = from_jax_params(tree)
    return optim.tree_leaves(shard_params(
        RankMesh(data, model, data_rank, model_rank), port, fsdp=fsdp))


def test_the_data_ranks_hold_different_target_counts():
    mask = _batch()["loss_mask"][:, 1:]
    assert mask[:2].sum() != mask[2:].sum()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("step", [1, 2])
def test_losses_equal_jax_sharded_step(runs, case, step):
    _, want, results, _ = runs
    data, model, _ = CASES[case]
    assert len(results[case]) == data * model
    for result in results[case]:
        assert result["rows"] == len(TARGETS) // data
        np.testing.assert_allclose(result[f"loss{step}"],
                                   want[case][f"loss{step}"], **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("step", [1, 2])
def test_every_updated_param_equals_jax_sharded_step(runs, case, step):
    _, want, results, _ = runs
    for result in results[case]:
        expected = _slices(want[case][f"params{step}"], case,
                           result["data_rank"], result["model_rank"])
        got = optim.tree_leaves(result[f"params{step}"])
        assert len(got) == len(expected)
        for i, (ours, theirs) in enumerate(zip(got, expected)):
            np.testing.assert_allclose(ours, theirs.numpy(),
                                       err_msg=f"leaf {i}", **TOL)
    # the step moved every leaf (AdamW at LR)
    first = optim.tree_leaves(results[case][0]["params1"])
    start = _slices(jax.tree.map(np.asarray, jax_tree(_jax_config(), seed=5)),
                    case, results[case][0]["data_rank"],
                    results[case][0]["model_rank"])
    assert all(not np.array_equal(a, b.numpy()) for a, b in zip(first, start))


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_gradient_equals_jax_whole_batch_gradient(runs, case):
    """The gradients the first step's AdamW update gets, on every rank:
    the rank's slices of JAX's gradient of the whole batch's loss (summed
    over "data" by the FSDP gathers' backward or the all-reduce). AdamW
    hides a gradient off by a factor, so they are held here directly.
    Under FSDP the backward gathered the layers again."""
    (_, grads), _, results, _ = runs
    data, _, fsdp = CASES[case]
    for result in results[case]:
        want = _slices(grads, case, result["data_rank"],
                       result["model_rank"])
        assert len(result["grads1"]) == len(want)
        for i, (ours, theirs) in enumerate(zip(result["grads1"], want)):
            np.testing.assert_allclose(ours, theirs.numpy(),
                                       err_msg=f"gradient leaf {i}", **TOL)
        assert (result["regathered"] > 0) == (fsdp and data > 1)


# replicated under TP (norms, a row-parallel bias), vocab-parallel (the
# embedding) and column-parallel from the images (the patch embedding):
# each gets a partial gradient if a replicated activation enters a
# column-parallel product without "f"
REPLICATED_UPSTREAM = ("/text/embed/w", "/text/final_norm/scale",
                       "/text/layers/0/ln1/scale", "/text/layers/1/ln2/scale",
                       "/vision/blocks/0/norm1/scale",
                       "/vision/blocks/1/norm2/scale",
                       "/vision/merger/ln_q/scale",
                       "/vision/blocks/0/attn/proj/b",
                       "/vision/patch_embed/w")


def _leaf_paths(tree, prefix: str = "") -> list[str]:
    """The leaves' paths in ``optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in _leaf_paths(tree[key], f"{prefix}/{key}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def test_tp_gradients_of_replicated_leaves_are_whole(runs):
    """Under TP the norm scales, a row-parallel bias, the vocab-parallel
    embedding and the patch embedding get JAX's whole gradient on every
    rank: the replicated activations enter the column-parallel products
    through "f", whose backward sums the ranks' partial gradients."""
    (_, grads), _, results, _ = runs
    paths = _leaf_paths(from_jax_params(grads))
    for result in results["tp_1x2"]:
        want = _slices(grads, "tp_1x2", 0, result["model_rank"])
        for path in REPLICATED_UPSTREAM:
            i = paths.index(path)
            got = result["grads1"][i]
            np.testing.assert_allclose(got, want[i].numpy(), err_msg=path,
                                       **TOL)
            assert np.abs(got).max() > 0


def test_port_dryrun_multichip_runs_jax_sequence(runs):
    summaries = runs[3]
    assert len(summaries) == DRYRUN_RANKS
    assert len(set(summaries)) == 1
    summary = summaries[0]
    assert summary.startswith(f"dryrun_multichip({DRYRUN_RANKS}): "
                              "mesh={'data': 2, 'model': 4} ")
    assert f"vl_read x4 + llm_chat x4" in summary
    assert f"ring_attn[seq {8 * DRYRUN_RANKS} over {DRYRUN_RANKS} ranks]" \
        in summary
    loss = float(summary.split("train[loss=")[1].split("]")[0])
    assert np.isfinite(loss)
