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


def port_engines(trees: dict, mesh=None):
    """(OCR backend, free reasoner, guided reasoner) of the port on the
    CPU over the given numpy trees, sharded over ``mesh`` when given."""
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
        engines = [engine.shard(mesh) for engine in engines]
    return engines


def serve(engines, schema: dict) -> dict:
    """What the engine cases compare: reads, a chat batch and one guided
    call."""
    ocr, llm, guided = engines
    return {"reads": ocr.read_batch(pages(), "Read.", 6),
            "chats": llm.chat_batch(TURNS, temperature=0.1, max_tokens=6),
            "guided": guided.chat(TURNS[1].system, TURNS[1].user,
                                  temperature=0.1, max_tokens=48,
                                  json_schema=schema)}


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
def tp_cases(rank: int, world: int, model_parallel: int, path: str) -> dict:
    """The TP forward, dense generate, both sharded engines and the
    vocab-parallel top-k over a (world / model_parallel, model_parallel)
    mesh, on the numpy trees and inputs pickled at ``path``."""
    from handwritten_ocr_tpu_torch.models.layers import argmax_ids, topk_ids
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.models.weights import from_jax_params
    from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh, model_group
    from handwritten_ocr_tpu_torch.parallel.sharding import shard_params

    with open(path, "rb") as handle:
        data = pickle.load(handle)
    mesh = make_mesh(model_parallel=model_parallel)
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "model_rank": mesh.get_local_rank("model")}
    vl = VLModel(shard_params(mesh, from_jax_params(data["trees"]["vl"])),
                 vl_config(), mesh)
    out["vl_logits"] = vl.forward_logits(
        data["vl_ids"], torch.from_numpy(data["patches"]),
        data["grid"]).numpy()
    qwen3 = Qwen3Model(shard_params(mesh, from_jax_params(
        data["trees"]["qwen3"])), qwen3_config(), mesh)
    gen = qwen3.generate(data["q_ids"], 8)
    out["dense"] = (gen.tokens.numpy(), gen.lengths.numpy())
    out.update(serve(port_engines(data["trees"], mesh), data["schema"]))
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
