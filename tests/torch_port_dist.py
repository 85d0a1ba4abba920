"""Process groups for the PyTorch port's multi-process CPU tests.

``run_group(world, fn, *args)`` starts ``world`` processes (spawn), each of
which joins one gloo group through the port's own
``parallel.distributed.initialize_from_env`` (``HOCR_DIST_*`` on a free
port of localhost, bound to port 0 so that concurrent test workers never
collide), runs ``fn(rank, world, *args)`` and sends its result back.
``fn`` must live in an importable module that does not import JAX (the
children import only torch and the port). A child's exception fails the
call with its traceback; a child that does not answer within ``timeout``
seconds fails it too (a rank that waits in a collective its peers never
reach would otherwise hang the run), and every child is stopped.
"""

from __future__ import annotations

import contextlib
import io
import os
import pickle
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer


class SmallTokenizer(ByteTokenizer):
    """ByteTokenizer with the chat template's special ids at 256-262 and a
    decode that gives every id one character, so a small vocabulary
    holds every id and random weights write digits, quotes and braces."""

    SPECIALS = {name: 256 + i for i, name in enumerate(ByteTokenizer.SPECIALS)}

    def decode(self, ids) -> str:
        return "".join(chr(int(i) % 256) for i in ids)


class SpellingTokenizer(SmallTokenizer):
    """SmallTokenizer whose decode spells every id, so compared texts
    carry the whole greedy token stream."""

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


IDS = SmallTokenizer.SPECIALS
EOS = IDS["<|im_end|>"]
# Tiny configs after the JAX package's tests/test_parallel.py, with the
# small tokenizer's ids (vocab 512 splits 2 and 4 ways).
QWEN3 = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, head_dim=16, eos_token_id=EOS,
             pad_token_id=0)
VISION = dict(depth=2, hidden_size=64, intermediate_size=128, num_heads=8,
              out_hidden_size=128, fullatt_block_indexes=(1,))
TEXT = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=4, mrope_section=(2, 3, 3))
VL_IDS = dict(image_token_id=IDS["<|image_pad|>"], video_token_id=511,
              vision_start_token_id=IDS["<|vision_start|>"],
              vision_end_token_id=IDS["<|vision_end|>"], eos_token_id=EOS,
              pad_token_id=0)
PIXELS = dict(min_pixels=28 * 28, max_pixels=112 * 112)


class Turn:
    def __init__(self, system, user):
        self.system, self.user = system, user


TURNS = [Turn("You are an editor.", "Fix: teh cat"),
         Turn("sys", "a much longer user message that lands in another "
                     "prefill bucket than the first one does"),
         Turn("x", "y")]


def pages() -> list[np.ndarray]:
    """Four 28-aligned uint8 pages of two grids (no resize on either
    side: both pack them on the host alike)."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for shape in ((56, 84, 3), (56, 84, 3), (84, 56, 3), (84, 56, 3))]


def vl_config():
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    return VLConfig(vision=VisionConfig(**VISION), text=TextConfig(**TEXT),
                    **VL_IDS)


def qwen3_config():
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
    return Qwen3Config(**QWEN3)


def port_engines(trees: dict, mesh=None, fsdp: bool = False):
    """(OCR backend, free reasoner, guided reasoner) of the port on the
    CPU over the given numpy trees, sharded over ``mesh`` when given
    (with FSDP over "data" when ``fsdp``)."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.models.weights import from_jax_params

    ocr = TorchOCRBackend(VLModel(from_jax_params(trees["vl"]), vl_config()),
                          SpellingTokenizer(), device="cpu", kv_quant=False,
                          **PIXELS)
    llm = [TorchReasoningBackend(
        Qwen3Model(from_jax_params(trees["qwen3"]), qwen3_config()),
        tokenizer, device="cpu", kv_quant=False)
        for tokenizer in (SpellingTokenizer(), SmallTokenizer())]
    engines = [ocr, *llm]
    if mesh is not None:
        engines = [engine.shard(mesh, fsdp=fsdp) for engine in engines]
    return engines


def serve(engines, schema: dict) -> dict:
    """What the engine cases compare: reads, a chat batch and one guided
    call; and, of each engine's batcher, whether its program's step would
    be captured on a card (``step_graph.graphable``) and the steps it
    replayed."""
    from handwritten_ocr_tpu_torch.engine.step_graph import graphable
    ocr, llm, guided = engines
    out = {"reads": ocr.read_batch(pages(), "Read.", 6),
           "chats": llm.chat_batch(TURNS, temperature=0.1, max_tokens=6),
           "guided": guided.chat(TURNS[1].system, TURNS[1].user,
                                 temperature=0.1, max_tokens=48,
                                 json_schema=schema)}
    batchers = [engine._batcher for engine in engines]
    out["graphable"] = [graphable(b.program, torch.device("cuda"))
                        for b in batchers]
    out["graph_steps"] = sum(b.stats["decode_graph_steps"] for b in batchers)
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, port: int, fn, args, results) -> None:
    os.environ.update(HOCR_DIST_COORD=f"localhost:{port}",
                      HOCR_DIST_NPROCS=str(world),
                      HOCR_DIST_PROC_ID=str(rank))
    try:
        import torch
        import torch.distributed as dist

        from handwritten_ocr_tpu_torch.parallel.distributed import (
            initialize_from_env)
        torch.set_num_threads(1)
        assert initialize_from_env() is True
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


class Group:
    """A started group; :meth:`results` waits for every rank's answer."""

    def __init__(self, world: int, fn, *args):
        ctx = mp.get_context("spawn")
        self.world = world
        self.queue = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_child,
                                  args=(r, world, port, fn, args, self.queue),
                                  daemon=True)
                      for r in range(world)]
        for proc in self.procs:
            proc.start()

    def results(self, timeout: float = 240) -> list:
        out: dict[int, object] = {}
        try:
            while len(out) < self.world:
                try:
                    rank, ok, value = self.queue.get(timeout=timeout)
                except queue.Empty:
                    raise AssertionError(
                        f"ranks {sorted(set(range(self.world)) - set(out))} "
                        f"gave no result within {timeout} s") from None
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for proc in self.procs:
                proc.join(timeout=10)
                if proc.is_alive():
                    proc.kill()
        return [out[r] for r in range(self.world)]


def run_group(world: int, fn, *args, timeout: float = 240) -> list:
    """Start a group and wait for its results (rank order)."""
    return Group(world, fn, *args).results(timeout)


# ── group cases (run in every rank of a group) ─────────────────────────
def tp_cases(rank: int, world: int, model_parallel: int, path: str,
             fsdp: bool = False) -> dict:
    """The TP forward, dense generate, both sharded engines and the
    vocab-parallel top-k over a (world / model_parallel, model_parallel)
    mesh, on the numpy trees and inputs pickled at ``path``; with
    ``fsdp`` every model is split over "data" as well (FSDP)."""
    from handwritten_ocr_tpu_torch.models.layers import argmax_ids, topk_ids
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.models.weights import from_jax_params
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh, model_group
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)

    with open(path, "rb") as handle:
        data = pickle.load(handle)
    mesh = make_mesh(model_parallel=model_parallel)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "model_rank": mesh.get_local_rank("model")}

    def placed(tree):
        full = from_jax_params(tree)
        specs = param_shardings(mesh, full, fsdp=True) if fsdp else None
        return dict(params=shard_params(mesh, full, fsdp=fsdp),
                    mesh=mesh, shardings=specs)

    vl = VLModel(config=vl_config(), **placed(data["trees"]["vl"]))
    out["vl_logits"] = vl.forward_logits(
        data["vl_ids"], torch.from_numpy(data["patches"]),
        data["grid"]).numpy()
    qwen3 = Qwen3Model(config=qwen3_config(), **placed(data["trees"]["qwen3"]))
    gen = qwen3.generate(data["q_ids"], 8)
    out["dense"] = (gen.tokens.numpy(), gen.lengths.numpy())
    out.update(serve(port_engines(data["trees"], mesh, fsdp),
                     data["schema"]))
    group = model_group(mesh)
    logits = torch.from_numpy(data["logits"])
    local = logits.shape[-1] // model_parallel
    shard = logits[:, out["model_rank"] * local:(out["model_rank"] + 1) * local]
    out["topk"] = topk_ids(shard, data["k"], group).numpy()
    out["argmax"] = argmax_ids(shard, group).numpy()
    return out


def ring_cases(rank: int, world: int, cases: dict) -> dict:
    """``ring_attention`` for each (mesh model_parallel, axis, causal, q,
    k, v) case; a sequence that does not split raises ValueError."""
    from handwritten_ocr_tpu_torch.parallel.context_parallel import (
        ring_attention)
    from handwritten_ocr_tpu_torch.parallel.mesh import (axis_rank,
                                                         make_mesh)
    meshes = {}
    out = {}
    for name, (model_parallel, axis, causal, q, k, v) in cases.items():
        if model_parallel not in meshes:
            meshes[model_parallel] = make_mesh(model_parallel=model_parallel)
        mesh = meshes[model_parallel]
        got = ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), mesh=mesh, axis=axis,
                             causal=causal)
        out[name] = (axis_rank(mesh, axis), got.numpy())
    try:
        ring_attention(torch.zeros(1, 31, 2, 16), torch.zeros(1, 31, 2, 16),
                       torch.zeros(1, 31, 2, 16), mesh=meshes[1])
    except ValueError as err:
        out["indivisible"] = str(err)
    return out


def cli_and_helpers(rank: int, world: int, runs: list) -> dict:
    """The port's CLI ``main(argv)`` in this rank for each argv of
    ``runs`` (joined to the group through HOCR_DIST_*; ``main`` joins
    again, a no-op), then the multi-process helpers over the same group:
    ``shard_host_batch`` over a (world, 1) mesh, ``replicate_params``
    over a (1, world) one."""
    from handwritten_ocr_tpu_torch.cli import transcribe
    from handwritten_ocr_tpu_torch.parallel import distributed

    printed = []
    for argv in runs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            transcribe.main(argv)
        printed.append(out.getvalue())
    data_mesh = distributed.global_mesh()
    data = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    asked = []

    def per_index(index):
        asked.append(index)
        return data[index]

    rows = distributed.shard_host_batch(data_mesh, per_index, data.shape)
    model_mesh = distributed.global_mesh(model_parallel=world)
    tree = {"layers": [{"mlp": {"down": {"w": torch.arange(8.).reshape(2, 4)},
                                "up": {"w": torch.arange(8.).reshape(4, 2)}}}]}
    placed = distributed.replicate_params(model_mesh, tree)
    return {"stdout": printed, "rows": rows.numpy(), "asked": asked,
            "coordinator": distributed.is_coordinator(),
            "initialized_again": distributed.initialize_from_env(),
            "down": placed["layers"][0]["mlp"]["down"]["w"].numpy(),
            "up": placed["layers"][0]["mlp"]["up"]["w"].numpy(),
            "data_rank": data_mesh.get_local_rank("data"),
            "model_rank": model_mesh.get_local_rank("model")}


class RankMesh:
    """A mesh's coordinates without a process group, for slicing a tree
    as the rank at (``data_rank``, ``model_rank``) of a (``data``,
    ``model``) mesh keeps it."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data: int, model: int, data_rank: int = 0,
                 model_rank: int = 0):
        self.shape = (data, model)
        self.ranks = {"data": data_rank, "model": model_rank}

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_local_rank(self, axis: str) -> int:
        return self.ranks[axis]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().numpy().copy()


def train_cases(rank: int, world: int, model_parallel: int, fsdp: bool,
                path: str) -> dict:
    """Two sharded train steps of the tiny VL over a (world /
    model_parallel, model_parallel) mesh, FSDP over "data" when
    ``fsdp``, on the numpy params and global batch pickled at ``path``
    (JAX's layout); returns the mesh coordinates, both losses, this
    rank's slices after each step, every gradient the first step's
    update got (the rank's slices, summed over "data") and how many
    tensors the backward gathered again (FSDP)."""
    from handwritten_ocr_tpu_torch.models.weights import from_jax_params
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)
    from handwritten_ocr_tpu_torch.train import optim
    from handwritten_ocr_tpu_torch.train.data import shard_batch
    from handwritten_ocr_tpu_torch.train.step import (TrainBatch,
                                                      make_train_step)
    from handwritten_ocr_tpu_torch.parallel import collectives

    with open(path, "rb") as handle:
        data = pickle.load(handle)
    mesh = make_mesh(model_parallel=model_parallel)
    cfg, grid = vl_config(), tuple(data["grid"])
    full = from_jax_params(data["params"])
    specs = param_shardings(mesh, full, fsdp=True) if fsdp else None
    params = shard_params(mesh, full, fsdp=fsdp)
    batch = shard_batch(mesh, TrainBatch(
        *(torch.from_numpy(data["batch"][name])
          for name in TrainBatch._fields)))
    out = {"data_rank": mesh.get_local_rank("data"),
           "model_rank": mesh.get_local_rank("model"),
           "rows": batch.input_ids.shape[0]}

    init, update = optim.adamw(data["lr"])
    seen = []

    def keeping(grads, state, params):
        seen.append([g.numpy().copy() for g in grads])
        return update(grads, state, params)

    unpacked = []
    regather = collectives._unpack

    def counting(packed):
        unpacked.append(not isinstance(packed, torch.Tensor))
        return regather(packed)

    collectives._unpack = counting
    init, step = make_train_step(cfg, grid, optimizer=(init, keeping),
                                 mesh=mesh, shardings=specs)
    state = init(params)
    for i in (1, 2):
        params, state, loss = step(params, state, batch)
        out[f"loss{i}"] = float(loss)
        out[f"params{i}"] = _numpy_tree(params)
    collectives._unpack = regather
    out["grads1"] = seen[0]
    out["regathered"] = sum(unpacked)
    return out


def dryrun_case(rank: int, world: int) -> str:
    """The port's ``dryrun_multichip`` on every rank, on the CPU."""
    from handwritten_ocr_tpu_torch.parallel.dryrun import dryrun_multichip
    return dryrun_multichip(world, device="cpu")


def train_cuda_cases(rank: int, world: int, model_parallel: int) -> dict:
    """On the card: a narrow fp32 VL (vision 4 x 80, text 4:2 x 128, the
    kernels' head sizes) one train step whole on this card and one step
    over a (world / model_parallel, model_parallel) mesh from the same
    weights and global batch (FSDP where the data axis is 2); the largest
    difference of the loss, of every gradient the update got and of
    every updated leaf (the rank's slices of the whole results), each
    less its 2e-4 relative allowance."""
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.models.qwen25vl.config import (
        TextConfig, VLConfig, VisionConfig)
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)
    from handwritten_ocr_tpu_torch.train import optim
    from handwritten_ocr_tpu_torch.train.data import shard_batch
    from handwritten_ocr_tpu_torch.train.step import (TrainBatch,
                                                      make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = VLConfig(
        vision=VisionConfig(depth=2, hidden_size=320, intermediate_size=640,
                            num_heads=4, fullatt_block_indexes=(1,),
                            out_hidden_size=512),
        text=TextConfig(vocab_size=512, hidden_size=512,
                        intermediate_size=1024, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2,
                        mrope_section=(16, 24, 24)), **VL_IDS)
    mesh = make_mesh(model_parallel=model_parallel)
    fsdp = world // model_parallel > 1
    grid = (1, 8, 8)
    rng = np.random.default_rng(3)
    prompt = ([1, IDS["<|vision_start|>"]] + [IDS["<|image_pad|>"]] * 16
              + [IDS["<|vision_end|>"], 3])
    ids = np.array([prompt + list(rng.integers(5, 250, 12))
                    for _ in range(2)])
    mask = np.zeros(ids.shape, np.float32)
    mask[0, len(prompt):len(prompt) + 5] = 1
    mask[1, len(prompt):] = 1
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
        rope_index_for_prompt)
    positions = np.stack([rope_index_for_prompt(row, cfg, [grid])[0]
                          for row in ids], axis=1)
    patches = rng.standard_normal((2, 64, 1176)).astype(np.float32)
    batch = TrainBatch(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                         for a in (ids, patches, positions, mask)))

    def run(step_mesh, specs, params, step_batch):
        # eps 1e-3: a gradient of rounding noise (the k biases', zero in
        # exact arithmetic) does not become a whole step of either sign
        init, update = optim.adamw(3e-3, eps=1e-3)
        seen = []

        def keeping(grads, state, leaves):
            seen.extend(g.clone() for g in grads)
            return update(grads, state, leaves)

        _, step = make_train_step(cfg, grid, (init, keeping), step_mesh,
                                  specs)
        params, _, loss = step(params, init(params), step_batch)
        return float(loss), seen, optim.tree_leaves(params)

    def draw():
        return init_vl(cfg, torch.float32, "cuda", seed=4)

    specs = param_shardings(mesh, draw(), fsdp=True) if fsdp else None
    loss, grads, params = run(mesh, specs,
                              shard_params(mesh, draw(), fsdp=fsdp),
                              shard_batch(mesh, batch))
    whole = draw()
    want_loss, want_grads, _ = run(None, None, whole, batch)
    it = iter(want_grads)
    grad_tree = optim.tree_map(lambda _: next(it), _sorted(whole))
    want_grads = optim.tree_leaves(shard_params(mesh, grad_tree, fsdp=fsdp))
    want = optim.tree_leaves(shard_params(mesh, whole, fsdp=fsdp))

    def excess(got, wanted):
        return max(float(((a - b).abs() - 2e-4 * b.abs()).max())
                   for a, b in zip(got, wanted, strict=True))

    return {"loss": (loss, want_loss), "grads": excess(grads, want_grads),
            "params": excess(params, want),
            "backend": torch.distributed.get_backend()}


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order (``tree_map``
    then visits the leaves in ``tree_leaves`` order)."""
    if isinstance(tree, dict):
        return {key: _sorted(tree[key]) for key in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree
