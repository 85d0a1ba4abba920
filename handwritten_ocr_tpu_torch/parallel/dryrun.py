"""The multi-rank dry run at small shapes (port of
``__graft_entry__.py:dryrun_multichip``).

Every rank of an ``n``-rank process group (joined before, e.g. by
:func:`parallel.distributed.initialize_from_env`) calls
:func:`dryrun_multichip` and runs, step for step as the JAX function:

  1. the serving memory plan of the flagship deployment (7B VLM + 32B
     LLM co-resident, int8, TP-sharded) at its defaults, which must fit;
  2. a sharded serving round: a batched read of ``2·data`` pages (TP
     over "model", pages over "data") and a batched chat of ``2·data``
     turns, both engines resident on one ("data", "model") mesh;
  3. ring attention over every rank (a causal sequence of ``8·n`` rows);
  4. one training step of a small VL (vision encode + splice + decoder +
     AdamW) with TP over "model" and FSDP over "data", on a batch of
     ``2·data`` pages split over "data".

It asserts what the JAX function asserts (the plan fits, one text per
page and turn, finite ring outputs and a finite loss) and returns the
summary line. The model axis is 4 where ``n`` divides by 4, else 2, else
1 (the small configs have 4 kv heads). Weights are drawn from fixed
seeds; nothing is read from disk. ``device``: the rank's card unless the
caller passes ``"cpu"``; ring attention on cards needs NCCL.
"""

from __future__ import annotations

import numpy as np
import torch

from handwritten_ocr_tpu_torch.models.qwen25vl.config import (TextConfig,
                                                              VLConfig,
                                                              VisionConfig)
from handwritten_ocr_tpu_torch.models.qwen25vl.model import (
    rope_index_for_prompt)
from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Config
from handwritten_ocr_tpu_torch.ops.dispatch import resolve_device
from handwritten_ocr_tpu_torch.parallel.mesh import axis_size, make_mesh


def small_vl_config() -> VLConfig:
    """``__graft_entry__.py:_small_vl_config``: the flagship's vocabulary
    at a small width and depth."""
    return VLConfig(
        vision=VisionConfig(depth=4, hidden_size=128, intermediate_size=256,
                            num_heads=8, out_hidden_size=256,
                            fullatt_block_indexes=(3,)),
        text=TextConfig(vocab_size=152064, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=4,
                        num_attention_heads=8, num_key_value_heads=4,
                        mrope_section=(4, 6, 6)))


def tiny_qwen3_config() -> Qwen3Config:
    """``__graft_entry__.py:_tiny_qwen3_config``."""
    return Qwen3Config(vocab_size=151936, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=8, num_key_value_heads=4,
                       head_dim=16)


def example_batch(cfg: VLConfig, batch: int = 2,
                  grid: tuple[int, int, int] = (1, 8, 8),
                  target_len: int = 8):
    """``__graft_entry__.py:_example_batch``: (input_ids, patches,
    position_ids, loss_mask) as numpy arrays, every row alike."""
    t, h, w = grid
    n_img = t * h * w // 4
    patch_dim = 3 * 2 * 14 * 14
    ids_row = ([151644, 10, 11, 151652] + [cfg.image_token_id] * n_img
               + [151653, 12, 13] + list(range(20, 20 + target_len)))
    input_ids = np.tile(np.array(ids_row, dtype=np.int64), (batch, 1))
    positions, _ = rope_index_for_prompt(input_ids[0], cfg, [grid])
    position_ids = np.broadcast_to(positions[:, None, :],
                                   (3, batch, input_ids.shape[1]))
    rng = np.random.default_rng(0)
    patches = rng.standard_normal((batch, t * h * w, patch_dim)
                                  ).astype(np.float32)
    loss_mask = np.zeros(input_ids.shape, dtype=np.float32)
    loss_mask[:, -target_len:] = 1.0
    return input_ids, patches, np.ascontiguousarray(position_ids), loss_mask


class _Turn:
    def __init__(self, system: str, user: str):
        self.system, self.user = system, user


def _serving_round(mesh, device) -> str:
    """Both engines on ``mesh``: a read of ``2·data`` pages and a chat of
    ``2·data`` turns; then ring attention over every rank."""
    from handwritten_ocr_tpu_torch.engine.torch_engines import (
        TorchOCRBackend, TorchReasoningBackend)
    from handwritten_ocr_tpu_torch.models.init import init_qwen3, init_vl
    from handwritten_ocr_tpu_torch.models.processor import ByteTokenizer
    from handwritten_ocr_tpu_torch.models.qwen25vl.model import VLModel
    from handwritten_ocr_tpu_torch.models.qwen3 import Qwen3Model
    from handwritten_ocr_tpu_torch.parallel.budget import coresident_plan
    from handwritten_ocr_tpu_torch.parallel.context_parallel import (
        ring_attention)

    plan = coresident_plan(VLConfig(), Qwen3Config())
    assert plan.fits, f"flagship serving plan over budget:\n{plan.report()}"

    vl_cfg, q_cfg = small_vl_config(), tiny_qwen3_config()
    ocr = TorchOCRBackend(
        VLModel(init_vl(vl_cfg, torch.float32, device, seed=7), vl_cfg),
        ByteTokenizer(), device=device).shard(mesh)
    llm = TorchReasoningBackend(
        Qwen3Model(init_qwen3(q_cfg, torch.float32, device, seed=8), q_cfg),
        ByteTokenizer(), device=device).shard(mesh)

    rng = np.random.default_rng(0)
    batch = axis_size(mesh, "data") * 2
    pages = [rng.integers(100, 256, (56, 56, 3), dtype=np.uint8)
             for _ in range(batch)]
    texts = ocr.read_batch(pages, "Extract the text.", 4)
    assert len(texts) == batch
    replies = llm.chat_batch(
        [_Turn("You are a critic.", f"Review page {i}.")
         for i in range(batch)],
        temperature=0.1, max_tokens=4)
    assert len(replies) == batch

    n = torch.distributed.get_world_size()
    ring = make_mesh(model_parallel=n)
    seq = n * 8
    qkv = torch.from_numpy(rng.standard_normal((3, 1, seq, 4, 32)
                                               ).astype(np.float32)).to(device)
    out = ring_attention(qkv[0], qkv[1], qkv[2], mesh=ring, axis="model",
                         causal=True)
    assert bool(torch.isfinite(out).all())
    return (f"serve[vl_read x{batch} + llm_chat x{batch}, "
            f"plan {plan.total_per_chip / 2**30:.1f}GiB/chip] "
            f"ring_attn[seq {seq} over {n} ranks] OK")


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None
                     ) -> str:
    """Sharded serving round + one sharded training step (small shapes),
    on every rank of a group of ``n_devices``; returns the summary line
    (rank 0 also prints it)."""
    from handwritten_ocr_tpu_torch.models.init import init_vl
    from handwritten_ocr_tpu_torch.parallel.sharding import (param_shardings,
                                                             shard_params)
    from handwritten_ocr_tpu_torch.train.data import shard_batch
    from handwritten_ocr_tpu_torch.train.step import (TrainBatch,
                                                      make_train_step)

    world = torch.distributed.get_world_size()
    assert world >= n_devices, f"need {n_devices} ranks, have {world}"
    device = resolve_device(device)
    model_parallel = (4 if n_devices % 4 == 0
                      else 2 if n_devices % 2 == 0 else 1)
    mesh = make_mesh(n_devices, model_parallel=model_parallel)

    serve_summary = _serving_round(mesh, device)

    cfg, grid = small_vl_config(), (1, 8, 8)
    batch = axis_size(mesh, "data") * 2          # 2 pages a data rank
    params = init_vl(cfg, torch.float32, device, seed=0)
    specs = param_shardings(mesh, params, fsdp=True)
    params = shard_params(mesh, params, fsdp=True)   # TP + FSDP
    arrays = example_batch(cfg, batch=batch, grid=grid)
    train_batch = shard_batch(mesh, TrainBatch(
        *(torch.from_numpy(a).to(device) for a in arrays)))
    opt_init, train_step = make_train_step(cfg, grid, mesh=mesh,
                                           shardings=specs)
    opt_state = opt_init(params)
    params, opt_state, loss = train_step(params, opt_state, train_batch)
    loss_val = float(loss)
    assert np.isfinite(loss_val), f"non-finite loss {loss_val}"
    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    summary = (f"dryrun_multichip({n_devices}): mesh={mesh_shape} "
               f"{serve_summary} train[loss={loss_val:.4f}] OK")
    if torch.distributed.get_rank() == 0:
        print(summary)
    return summary
