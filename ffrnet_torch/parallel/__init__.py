"""Parallelism on torch.distributed (ffrnet_tpu/parallel/): the ('data',
'model') mesh, the process group of a launcher, and the collectives of both
axes."""

from ffrnet_torch.parallel.mesh import (LocalMesh, class_shard, data_group, group_size,
                                        host_group, make_mesh, maybe_init_distributed,
                                        mesh_axes, mesh_coordinate, mesh_dims, model_group,
                                        padded_num_classes, rank, shutdown_distributed,
                                        validate_batch_for_mesh, world_size)

__all__ = ["LocalMesh", "class_shard", "data_group", "group_size", "host_group", "make_mesh",
           "maybe_init_distributed", "mesh_axes", "mesh_coordinate", "mesh_dims", "model_group",
           "padded_num_classes", "rank", "shutdown_distributed", "validate_batch_for_mesh",
           "world_size"]
