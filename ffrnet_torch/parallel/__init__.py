"""Data parallelism on torch.distributed (ffrnet_tpu/parallel/): the mesh,
the process group of a launcher, and the collectives of the data axis."""

from ffrnet_torch.parallel.mesh import (LocalMesh, data_group, group_size, host_group,
                                        make_mesh, maybe_init_distributed, mesh_axes,
                                        mesh_dims, rank, shutdown_distributed,
                                        validate_batch_for_mesh, world_size)

__all__ = ["LocalMesh", "data_group", "group_size", "host_group", "make_mesh",
           "maybe_init_distributed", "mesh_axes", "mesh_dims", "rank", "shutdown_distributed",
           "validate_batch_for_mesh", "world_size"]
