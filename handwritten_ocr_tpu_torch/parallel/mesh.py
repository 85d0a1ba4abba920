"""Device mesh construction over a ``torch.distributed`` process group.

Port of ``handwritten_ocr_tpu/parallel/mesh.py``. Axes:
  "data"  — pages / requests (data parallel)
  "model" — tensor parallel (attention heads, MLP columns, vocabulary)

One process per rank. Ranks are laid out row-major, as the JAX package
reshapes ``jax.devices()``: rank r = d·model + m, so the ranks of one
model group are adjacent (on one host, its TP collectives stay on the
host's links).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def mesh_shape_for(n_devices: int, model_parallel: int | None = None) -> tuple[int, int]:
    """(data, model) shape: the model axis as asked (default 1)."""
    if model_parallel is None:
        # Default: favor data parallelism; model axis 1 unless the caller
        # asks otherwise (OCR page workloads are embarrassingly data
        # parallel; TP is for fitting big models).
        model_parallel = 1
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return n_devices // model_parallel, model_parallel


def make_mesh(n_devices: int | None = None,
              model_parallel: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group
    (joined before, e.g. by ``parallel.distributed.initialize_from_env``).
    ``n_devices`` defaults to the group's size and must equal it.
    ``device_type`` defaults to "cuda" where there is a card, else "cpu";
    each rank binds its card before it builds the mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize_from_env() first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {world}")
    data, model = mesh_shape_for(n_devices, model_parallel)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n_devices).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def model_group(mesh: DeviceMesh | None):
    """The process group of this rank's "model" axis: the group the TP
    forward all-reduces over. None without a mesh or with a model axis of
    1, where every function runs as on one device."""
    if axis_size(mesh, "model") < 2:
        return None
    return mesh.get_group("model")


def data_group(mesh: DeviceMesh | None):
    """The process group of this rank's "data" axis: the group FSDP
    gathers over and the gradients of data parallelism are summed over.
    None without a mesh or with a data axis of 1."""
    if axis_size(mesh, "data") < 2:
        return None
    return mesh.get_group("data")
