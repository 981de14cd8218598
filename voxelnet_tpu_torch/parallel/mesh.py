"""The config's mesh on the port's processes, the counterpart of
`voxelnet_tpu/parallel/mesh.py` (`make_mesh`) and
`voxelnet_tpu/parallel/distributed.py` (`make_multihost_mesh`).

The JAX package lays `system.num_dcn_shards x num_data_shards x
num_model_shards` devices out as a ('dcn', 'data', 'model') mesh, shards
the batch over ('dcn', 'data') jointly and the BEV grid's W axis over
'model'. The port runs one process per card, in the JAX device order:
rank = (dcn_i * num_data + d) * num_model + m, so the product of the three
must equal the running world size. The processes that share m form a
data group (they hold the same W slab of different rows); those that
share (dcn_i, d) form a model group (the same rows, one W slab each, the
voxel table replicated among them). The global batch is split into
contiguous row blocks in the order of the data index dcn_i * num_data + d,
as the JAX package's per-process loading splits it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from voxelnet_tpu_torch.parallel import distributed

LAUNCH = ("python -m torch.distributed.run --standalone --nproc_per_node {n} "
          "-m voxelnet_tpu_torch.cli.train --exp-dir <shared dir> ...")


class ProcessMesh(NamedTuple):
    """The config's mesh, mapped onto the processes: this process's rank,
    its data index and model index, and, with a model axis, its data
    group and model group (without one both are None: the data group is
    then the world)."""

    world_size: int
    rank: int
    num_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: distributed.Group | None = None
    model_group: distributed.Group | None = None

    @property
    def num_data(self) -> int:
        """The batch shards: num_dcn_shards x num_data_shards."""
        return self.world_size // self.num_model

    def process_shard(self) -> tuple[int, int] | None:
        """(data index, batch shards) for per-process loading
        (data/dataset.plan_batches): model peers load the same rows. None
        with one batch shard."""
        return ((self.data_index, self.num_data) if self.num_data > 1
                else None)

    def local_num_real(self, num_real: int, batch_size: int) -> int:
        """The real (non-padding) frames among this process's rows of a
        global batch of `batch_size` rows whose first `num_real` are
        real."""
        local = batch_size // self.num_data
        return int(np.clip(num_real - self.data_index * local, 0, local))


def process_mesh(system) -> ProcessMesh:
    """`system` (config.SystemConfig) -> ProcessMesh of the running
    process group; on first use with a model axis, every process makes
    the data and model groups (in the same order). Raises where the port
    cannot give the configured mesh: a mesh above 1 with no process group
    up; a mesh whose size is not the world size."""
    nm = system.num_model_shards
    n = system.num_dcn_shards * system.num_data_shards * nm
    world = distributed.world_size()
    sizes = (f"system.num_dcn_shards x num_data_shards x num_model_shards "
             f"= {system.num_dcn_shards} x {system.num_data_shards} x {nm} "
             f"= {n}")
    if n > 1 and not distributed.is_initialized():
        raise ValueError(
            f"{sizes} asks for {n} processes, one card each, but no "
            "torch.distributed process group is up: launch them with "
            f"`{LAUNCH.format(n=n)}` (or set VOXELNET_COORDINATOR, "
            "VOXELNET_NUM_PROCESSES and VOXELNET_PROCESS_ID in each), or "
            "set all three to 1 for one process")
    if n != world:
        fit = (f"num_data_shards: {world // nm} (with num_dcn_shards: 1)"
               if world % nm == 0 else f"num_data_shards: {world} (with "
               "num_dcn_shards: 1 and num_model_shards: 1)")
        raise ValueError(
            f"{sizes}, but {world} processes are running: launch "
            f"`{LAUNCH.format(n=n)}`, or set system.{fit}")
    rank = distributed.rank()
    if nm == 1:
        return ProcessMesh(world_size=world, rank=rank, data_index=rank)
    nd = world // nm
    data = [distributed.make_group("data", range(m, world, nm))
            for m in range(nm)]
    model = [distributed.make_group("model", range(d * nm, (d + 1) * nm))
             for d in range(nd)]
    d, m = divmod(rank, nm)
    return ProcessMesh(world_size=world, rank=rank, num_model=nm,
                       data_index=d, model_index=m, data_group=data[m],
                       model_group=model[d])
