"""The ('data', 'model') mesh on torch.distributed (ffrnet_tpu/parallel/mesh.py).

One process per card; the ranks are laid out as arange(D * M).reshape(D,
M), so the M ranks of one model group are adjacent. A training batch is
sharded over 'data' (each rank's BatchLoader takes its strided share; the
ranks of a model group take the same one), RecNet's train-mode BatchNorms
take their statistics over the data group (ops.nn.batch_norm_train) and
the gradients are averaged before the update. The one large weight, the
CosFace classifier (num_classes x 512), and its optimizer moments are
sharded over 'model' by class rows (`class_shard`, the JAX package's
P("model", None)): the class axis is zero-padded to a multiple of M
(`padded_num_classes`) and the padded rows are masked out of the softmax
and the argmax (models/recnet.py::add_margin_logits). Everything else is
replicated.

`maybe_init_distributed` joins the process group of a launcher
(torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, or
FFRNET_DISTRIBUTED=1 with the same variables): NCCL with one card per
rank for a CUDA device, gloo for the CPU. Beside an NCCL group it keeps a
gloo group for collectives of host tensors (`host_group`), which NCCL
cannot carry.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")

_HOST_GROUP = None  # the gloo group beside an NCCL default group


class LocalMesh:
    """The one-rank ('data', 'model') mesh of a process outside any process
    group: the same names and sizes as a DeviceMesh, and no group."""

    shape = (1, 1)
    mesh_dim_names = AXES

    def get_group(self, mesh_dim=None):
        return None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_axes(mesh) -> Dict[str, int]:
    """{'data': n_data, 'model': n_model} (the JAX Mesh's `shape`)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def mesh_dims(n_data: Optional[int], n_model: int, n_devices: int):
    """Validate a mesh shape over `n_devices` ranks and fill n_data in ->
    (n_data, n_model), with the JAX package's messages: an oversized axis
    raises, ranks left over warn on stderr."""
    if n_model < 1:
        raise ValueError(f"--mesh_model must be >= 1, got {n_model}")
    if n_model > n_devices:
        raise ValueError(
            f"--mesh_model {n_model} exceeds the {n_devices} visible "
            "devices")
    if n_data is None:
        n_data = n_devices // n_model
    if n_data < 1 or n_data * n_model > n_devices:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) needs "
            f"{max(n_data, 1) * n_model} devices but only {n_devices} "
            "are visible — lower --mesh_data/--mesh_model")
    used = n_data * n_model
    if used < n_devices:
        print(f"[warn] mesh ({n_data}x{n_model}) uses {used} of "
              f"{n_devices} devices — {n_devices - used} idle",
              file=sys.stderr)
    return n_data, n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """('data', 'model') mesh over the ranks of the process group (default:
    all of them), validated as the JAX package's make_mesh. Outside a
    process group the world is this one process: a LocalMesh."""
    n_data, n_model = mesh_dims(n_data, n_model, world_size())
    if not dist.is_initialized():
        return LocalMesh()
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def padded_num_classes(num_classes: int, n_model: int) -> int:
    """The smallest multiple of n_model >= num_classes
    (ffrnet_tpu/training/trainer.py:217; 10575 is odd, so every even model
    axis pads)."""
    return -(-num_classes // n_model) * n_model


def class_shard(num_classes: int, n_model: int, j: int):
    """-> (offset, rows): model rank j's rows [offset, offset + rows) of the
    class axis padded to padded_num_classes(num_classes, n_model)."""
    rows = padded_num_classes(num_classes, n_model) // n_model
    return j * rows, rows


def mesh_coordinate(mesh):
    """This rank's (data, model) coordinate; (0, 0) outside a process group.
    A rank outside the mesh (idle) raises."""
    if isinstance(mesh, LocalMesh):
        return 0, 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {rank()} is idle in {mesh}: it holds no shard")
    return int(coord[0]), int(coord[1])


def validate_batch_for_mesh(mesh, batch_size: int, flag: str = "--batch_size") -> None:
    """Fail fast with an actionable message when the global batch does not
    divide the 'data' mesh axis."""
    n_data = mesh_axes(mesh)["data"]
    if batch_size % n_data != 0:
        raise ValueError(
            f"{flag} {batch_size} is not divisible by the data-parallel mesh "
            f"size {n_data}; pick a multiple of {n_data} or change --mesh_data"
        )


def data_group(mesh):
    """The process group of this rank's 'data' axis (the ranks that share its
    model coordinate), or None where the axis has one rank (the
    single-process step runs as it is)."""
    if mesh_axes(mesh)["data"] == 1:
        return None
    mesh_coordinate(mesh)
    return mesh.get_group("data")


def model_group(mesh):
    """The process group of this rank's 'model' axis (the ranks that share its
    data coordinate and hold the class shards of one batch), or None where
    the axis has one rank."""
    if mesh_axes(mesh)["model"] == 1:
        return None
    mesh_coordinate(mesh)
    return mesh.get_group("model")


def group_size(group) -> int:
    """Ranks in `group`; 1 for None (no group)."""
    return 1 if group is None else dist.get_world_size(group)


def host_group():
    """The group for collectives of host (CPU) tensors: the default group
    under gloo, the gloo group made beside NCCL by maybe_init_distributed."""
    if not dist.is_initialized() or dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        raise RuntimeError("an NCCL process group without its gloo host group: join the "
                           "group through parallel.maybe_init_distributed")
    return _HOST_GROUP


def maybe_init_distributed(device="cuda") -> Optional[torch.device]:
    """Join the launcher's process group (ffrnet_tpu/train.py:90-106) when
    FFRNET_DISTRIBUTED=1, or torchrun's RANK and WORLD_SIZE, are set ->
    this rank's device (cuda:LOCAL_RANK for a CUDA device); None when the
    run is a single process. A failed initialization raises: a run that
    asked for the data axis never continues as a single process."""
    global _HOST_GROUP

    env = os.environ
    if env.get("FFRNET_DISTRIBUTED") != "1" and not ("RANK" in env and "WORLD_SIZE" in env):
        return None
    from ffrnet_torch.api import resolve_device

    r, world = int(env.get("RANK", "0")), int(env.get("WORLD_SIZE", "1"))
    local = int(env.get("LOCAL_RANK", str(r)))
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {r}: LOCAL_RANK {local} but only "
                               f"{torch.cuda.device_count()} cards are visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    addr, port = env.get("MASTER_ADDR", "127.0.0.1"), env.get("MASTER_PORT", "29500")
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=r,
                                world_size=world, **kw)
        if backend == "nccl":
            _HOST_GROUP = dist.new_group(backend="gloo")
    print(f"[dist] process {dist.get_rank()}/{dist.get_world_size()} on {dev} "
          f"({dist.get_backend()})", file=sys.stderr, flush=True)
    return dev


def shutdown_distributed() -> None:
    """Leave the process group that maybe_init_distributed joined."""
    global _HOST_GROUP

    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
