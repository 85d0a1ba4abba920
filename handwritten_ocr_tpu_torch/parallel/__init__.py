"""Parallelism: memory planning, process groups, meshes, tensor-parallel
sharding and ring attention.

Port of ``handwritten_ocr_tpu/parallel/``:
  * ``budget``      — device-memory plan of the co-resident engines.
  * ``mesh``        — ("data", "model") ``DeviceMesh`` over the group.
  * ``sharding``    — Megatron-style tensor-parallel specs and slices of
    both model families, FSDP's "data" blocks and their per-layer
    gather; the forward calls the collectives itself.
  * ``collectives`` — the differentiable collectives of the sharded
    forward (Megatron's "f" and "g", the TP and FSDP gathers).
  * ``dryrun``      — the multi-rank dry run (a sharded serving round,
    ring attention, one TP + FSDP train step) at small shapes.
  * ``context_parallel`` — ring attention: sequence-sharded attention
    with K/V chunks passed around the ring.
  * ``distributed`` — the ``torch.distributed`` process group (NCCL where
    each rank has a card, gloo otherwise), global meshes, and per-rank
    batch and parameter slices.
"""

from handwritten_ocr_tpu_torch.parallel.context_parallel import ring_attention
from handwritten_ocr_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_from_env,
    is_coordinator,
)
from handwritten_ocr_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from handwritten_ocr_tpu_torch.parallel.sharding import (
    data_sharding,
    param_shardings,
    replicated,
    shard_params,
)

__all__ = [
    "make_mesh", "mesh_shape_for",
    "param_shardings", "data_sharding", "replicated", "shard_params",
    "ring_attention",
    "initialize_from_env", "global_mesh", "is_coordinator",
]
