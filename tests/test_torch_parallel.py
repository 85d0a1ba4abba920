"""Tensor and data parallelism of the PyTorch port against the JAX package.

The port shards over a ("data", "model") ``DeviceMesh`` of a gloo process
group, one process per rank (``tests/torch_port_dist.py``): at (data,
model) = (1, 2) and (2, 2) every rank's TP forward, dense generate,
sharded engines (reads, a chat batch, one guided call) and vocab-parallel
top-k are held against the JAX package's single-device results on the
same weights (JAX's ``init_vl`` / ``init_qwen3``, carried over by
``from_jax_params``) and against the unsharded port. The specs are held
against JAX's ``param_shardings`` leaf by leaf, through the change of
layout (``[in, out]`` stacked layers in JAX, ``[out, in]`` per layer in
the port), and the ranks' slices must concatenate to every leaf.

Both groups start once for the module and run beside the JAX references.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwritten_ocr_tpu.engine.jax_engines import (JaxOCRBackend,
                                                    JaxReasoningBackend)
from handwritten_ocr_tpu.models.init import init_qwen3 as jax_init_qwen3
from handwritten_ocr_tpu.models.qwen25vl.config import (
    TextConfig as JaxTextConfig, VLConfig as JaxVLConfig,
    VisionConfig as JaxVisionConfig)
from handwritten_ocr_tpu.models.qwen25vl.model import (
    VLModel as JaxVLModel, rope_index_for_prompt)
from handwritten_ocr_tpu.models.qwen3 import (Qwen3Config as JaxQwen3Config,
                                              Qwen3Model as JaxQwen3Model)
from handwritten_ocr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from handwritten_ocr_tpu.parallel.sharding import (
    param_shardings as jax_param_shardings)
from handwritten_ocr_tpu.train.step import vl_forward
from handwritten_ocr_tpu_torch.agents.schemas import CriticResult
from handwritten_ocr_tpu_torch.models.layers import argmax_ids, topk_ids
from handwritten_ocr_tpu_torch.models.weights import from_jax_params
from handwritten_ocr_tpu_torch.parallel.mesh import mesh_shape_for
from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                         shard_params)
from torch_port_dist import (IDS, PIXELS, QWEN3, TEXT, TURNS, VISION, VL_IDS,
                             Group, SmallTokenizer, SpellingTokenizer, pages,
                             port_engines, serve, tp_cases)
from torch_port_tiny import jax_tree

torch.set_num_threads(1)

# name: (world, model axis); "_fsdp": every model split over "data" too
MESHES = {"1x2": (2, 2), "2x2": (4, 2), "2x2_fsdp": (4, 2)}
GRID = (1, 4, 4)
TOPK = 64


def jax_configs():
    return (JaxVLConfig(vision=JaxVisionConfig(**VISION),
                        text=JaxTextConfig(**TEXT), **VL_IDS),
            JaxQwen3Config(**QWEN3))


def planted_logits() -> np.ndarray:
    """[6, 512] fp32 logits with ties inside and across the vocab shards
    (a whole row equal, ties straddling the k-th place and the shard
    boundaries at 128, 256 and 384, infinities, negatives)."""
    rng = np.random.default_rng(0)
    logits = rng.integers(-3, 4, (6, 512)).astype(np.float32)
    logits[0] = 1.5
    logits[1, [7, 3, 250, 256, 300, 511]] = 9.0
    logits[2] = rng.normal(size=512).astype(np.float32)
    logits[2, [5, 6, 100, 400]] = -np.inf
    logits[3, ::2] = np.float32(1e-30)
    logits[4] = -logits[4]
    logits[5, [127, 128, 255, 256, 383, 384]] = 7.0
    return logits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, unsharded port results, {mesh: per-rank results})."""
    jax_vl_cfg, jax_q_cfg = jax_configs()
    vl_tree = jax.tree_util.tree_map(np.asarray, jax_tree(jax_vl_cfg, seed=3))
    q_tree = jax.tree_util.tree_map(np.asarray, jax_init_qwen3(
        jax.random.PRNGKey(5), jax_q_cfg, dtype=jnp.float32, quantize="int8"))
    n_image = GRID[1] * GRID[2] // 4
    vl_row = ([1, 2, IDS["<|vision_start|>"]] + [IDS["<|image_pad|>"]] * n_image
              + [IDS["<|vision_end|>"], 3, 4, 5])
    data = {"trees": {"vl": vl_tree, "qwen3": q_tree},
            "vl_ids": np.array([vl_row, vl_row], np.int64),
            "patches": np.random.default_rng(0).standard_normal(
                (2, GRID[0] * GRID[1] * GRID[2], 3 * 2 * 14 * 14)
            ).astype(np.float32),
            "grid": GRID,
            "q_ids": np.arange(1, 13, dtype=np.int64)[None].repeat(2, axis=0),
            "schema": CriticResult.json_schema(),
            "logits": planted_logits(), "k": TOPK}
    path = tmp_path_factory.mktemp("tp") / "inputs.pkl"
    path.write_bytes(pickle.dumps(data))
    groups = {name: Group(world, tp_cases, model, str(path),
                          name.endswith("_fsdp"))
              for name, (world, model) in MESHES.items()}

    with jax.default_matmul_precision("highest"):
        positions, _ = rope_index_for_prompt(data["vl_ids"][0], jax_vl_cfg,
                                             [GRID])
        positions = np.broadcast_to(positions[:, None], (3, 2, len(vl_row)))
        want = {
            "vl_logits": np.asarray(vl_forward(
                vl_tree, jax_vl_cfg, jnp.asarray(data["vl_ids"], jnp.int32),
                jnp.asarray(data["patches"]), GRID, jnp.asarray(positions))),
            "dense": JaxQwen3Model(q_tree, jax_q_cfg).generate(
                data["q_ids"], 8),
            "reads": JaxOCRBackend(JaxVLModel(vl_tree, jax_vl_cfg),
                                   SpellingTokenizer(), **PIXELS).read_batch(
                pages(), "Read.", 6),
            "chats": JaxReasoningBackend(
                JaxQwen3Model(q_tree, jax_q_cfg), SpellingTokenizer()
            ).chat_batch(TURNS, temperature=0.1, max_tokens=6),
            "guided": JaxReasoningBackend(
                JaxQwen3Model(q_tree, jax_q_cfg), SmallTokenizer()
            ).chat(TURNS[1].system, TURNS[1].user, temperature=0.1,
                   max_tokens=48, json_schema=data["schema"])}
    unsharded = serve(port_engines(data["trees"]), data["schema"])
    return want, unsharded, {name: group.results(timeout=400)
                             for name, group in groups.items()}


def test_mesh_shapes():
    assert mesh_shape_for(8) == (8, 1)
    assert mesh_shape_for(8, model_parallel=4) == (2, 4)
    assert mesh_shape_for(4, model_parallel=2) == (2, 2)
    with pytest.raises(ValueError):
        mesh_shape_for(8, model_parallel=3)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_group_meshes_are_row_major(runs, mesh):
    world, model = MESHES[mesh]
    for rank, result in enumerate(runs[2][mesh]):
        assert result["mesh"] == {"data": world // model, "model": model}
        assert result["model_rank"] == rank % model


def _trees():
    jax_vl_cfg, jax_q_cfg = jax_configs()
    return {"vl": jax_tree(jax_vl_cfg, seed=3),
            "qwen3_int8": jax_init_qwen3(jax.random.PRNGKey(5), jax_q_cfg,
                                         dtype=jnp.float32, quantize="int8")}


def _leaves(tree, path=()):
    """(path, leaf) of a tree of dicts and lists, list indices as digits."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    elif isinstance(tree, list):
        for index, value in enumerate(tree):
            yield from _leaves(value, path + (str(index),))
    else:
        yield path, tree


def _jax_spec_in_port_layout(path, jax_specs, ndim: int) -> tuple:
    """JAX's spec of the leaf the port stores at ``path``: the stacked
    leaf's spec without its [L] entry, a linear weight's two entries
    swapped ([in, out] -> [out, in])."""
    names = [p for p in path if not p.isdigit()]
    node = jax_specs
    for name in names:
        node = node[name]
    spec = tuple(node.spec)
    stacked = "layers" in names or "blocks" in names
    spec = spec + (None,) * (ndim + stacked - len(spec))
    if stacked:
        spec = spec[1:]
    if names[-1] in ("w", "w_q") and names[-2] != "embed" and ndim == 2:
        spec = spec[::-1]
    return spec


@pytest.mark.parametrize("tree", ["vl", "qwen3_int8"])
def test_every_spec_equals_jax_param_shardings(tree):
    jax_params = _trees()[tree]
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params))
    jax_specs = jax_param_shardings(jax_make_mesh(8, model_parallel=4),
                                    jax_params)
    specs = dict(_leaves(param_shardings(None, port)))
    leaves = list(_leaves(port))
    assert len(leaves) == len(specs)
    names = set()
    for path, leaf in leaves:
        spec = specs[path] + (None,) * (leaf.dim() - len(specs[path]))
        assert spec == _jax_spec_in_port_layout(path, jax_specs, leaf.dim()), \
            path
        names.add(path[-1])
    if tree == "qwen3_int8":
        assert {"w_q", "w_scale"} <= names
    else:
        assert specs[("vision", "blocks", "0", "attn", "qkv", "w")] == \
            ("model", None)
        assert specs[("vision", "patch_embed", "w")] == ("model", None)


class _Mesh:
    """A mesh's coordinates without a process group (slicing only)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, model: int, rank: int):
        self.model, self.rank = model, rank

    def size(self, dim: int) -> int:
        return (1, self.model)[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.rank if axis == "model" else 0


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tree", ["vl", "qwen3_int8"])
def test_rank_slices_concatenate_to_every_leaf(tree, tp):
    """Each rank's slices, concatenated over the ranks along the spec's
    dimension, give back every leaf; the fused vision qkv per third (each
    rank holds its heads' q, k and v rows)."""
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, _trees()[tree]))
    shards = [dict(_leaves(shard_params(_Mesh(tp, r), port)))
              for r in range(tp)]
    specs = dict(_leaves(param_shardings(None, port)))
    for path, leaf in _leaves(port):
        parts = [shard[path] for shard in shards]
        if "model" not in specs[path]:
            assert all(part is leaf for part in parts), path
            continue
        dim = specs[path].index("model")
        assert all(part.shape[dim] == leaf.shape[dim] // tp
                   for part in parts), path
        if "qkv" in path:
            parts = [p.unflatten(dim, (3, -1)) for p in parts]
            whole = torch.cat(parts, dim + 1).flatten(dim, dim + 1)
        else:
            whole = torch.cat(parts, dim)
        torch.testing.assert_close(whole, leaf, rtol=0, atol=0)
    if tree == "vl":
        hd = VISION["hidden_size"] // VISION["num_heads"]
        qkv = port["vision"]["blocks"][0]["attn"]["qkv"]["w"]
        mine = shards[1][("vision", "blocks", "0", "attn", "qkv", "w")]
        per = VISION["num_heads"] // tp * hd
        d = VISION["hidden_size"]
        for third in range(3):        # rank 1 holds heads H/tp..2H/tp-1
            torch.testing.assert_close(
                mine[third * per:(third + 1) * per],
                qkv[third * d + per:third * d + 2 * per], rtol=0, atol=0)


class _GridMesh:
    """A (data, model) mesh's coordinates without a process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int, data_rank: int, model_rank: int):
        self.shape, self.ranks = (data, model), (data_rank, model_rank)

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.ranks[self.mesh_dim_names.index(axis)]


@pytest.mark.parametrize("tree", ["vl", "qwen3_int8"])
def test_fsdp_specs_add_the_data_axis_and_sharding_raises(tree):
    """FSDP specs name "data" beside "model"; the (2, 2) ranks' "data"
    blocks, put back together over "data" and then over "model", give
    every leaf (int8 ``w_q`` / ``w_scale`` too), and a leaf whose
    dimension does not split over "data" raises, naming the leaf."""
    port = from_jax_params(jax.tree_util.tree_map(np.asarray, _trees()[tree]))
    specs = dict(_leaves(param_shardings(None, port, fsdp=True)))
    first = ("layers", "0", "attn", "q", "w_q") if tree == "qwen3_int8" \
        else ("text", "layers", "0", "attn", "q", "w")
    assert "model" in specs[first] and "data" in specs[first]
    tp = {m: dict(_leaves(shard_params(_Mesh(2, m), port))) for m in (0, 1)}
    shards = {(d, m): dict(_leaves(shard_params(_GridMesh(2, 2, d, m), port,
                                                fsdp=True)))
              for d in (0, 1) for m in (0, 1)}
    split = 0
    for path, leaf in _leaves(port):
        for m in (0, 1):
            parts = [shards[(d, m)][path] for d in (0, 1)]
            if "data" not in specs[path]:
                for part in parts:
                    torch.testing.assert_close(part, tp[m][path], rtol=0,
                                               atol=0)
                continue
            split += 1
            torch.testing.assert_close(
                torch.cat(parts, specs[path].index("data")), tp[m][path],
                rtol=0, atol=0)
    assert split > len(specs)     # most leaves split, on both model ranks
    odd = {"layers": [{"ln1": {"scale": torch.ones(3)}}]}
    with pytest.raises(ValueError, match="layers/0/ln1/scale"):
        shard_params(_GridMesh(2, 1, 0, 0), odd, fsdp=True)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_vl_forward_matches_jax(runs, mesh):
    want = runs[0]["vl_logits"]
    for result in runs[2][mesh]:
        np.testing.assert_allclose(result["vl_logits"], want, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_qwen3_dense_generate_matches_jax(runs, mesh):
    want = runs[0]["dense"]
    for result in runs[2][mesh]:
        tokens, lengths = result["dense"]
        np.testing.assert_array_equal(tokens, np.asarray(want.tokens))
        np.testing.assert_array_equal(lengths, np.asarray(want.lengths))


@pytest.mark.parametrize("call", ["reads", "chats", "guided"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_engines_equal_unsharded_and_jax(runs, mesh, call):
    want, unsharded, groups = runs
    assert unsharded[call] == want[call]
    for result in groups[mesh]:
        assert result[call] == want[call]
    if call == "guided":
        CriticResult.validate(json.loads(want[call]))
    else:
        assert all(len(text.split()) >= 1 for text in want[call])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_programs_step_eagerly(runs, mesh):
    """A TP or FSDP rank's batchers would not capture their step on a card
    (its collectives and gathers stay eager); the unsharded engines'
    would. On the CPU none replays a step."""
    _, unsharded, groups = runs
    assert unsharded["graphable"] == [True, True, True]
    assert unsharded["graph_steps"] == 0
    for result in groups[mesh]:
        assert result["graphable"] == [False, False, False]
        assert result["graph_steps"] == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_vocab_parallel_topk_equals_full_vocab_topk(runs, mesh):
    logits = torch.from_numpy(planted_logits())
    want = topk_ids(logits, TOPK).numpy()
    np.testing.assert_array_equal(
        want, np.argsort(-planted_logits(), axis=-1, kind="stable")[:, :TOPK])
    for result in runs[2][mesh]:
        np.testing.assert_array_equal(result["topk"], want)
        np.testing.assert_array_equal(result["argmax"],
                                      argmax_ids(logits).numpy())
