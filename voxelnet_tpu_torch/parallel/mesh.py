"""The config's mesh on the port's processes, the counterpart of
`voxelnet_tpu/parallel/mesh.py` (`make_mesh`) and
`voxelnet_tpu/parallel/distributed.py` (`make_multihost_mesh`).

The JAX package lays `system.num_dcn_shards x num_data_shards x
num_model_shards` devices out as a ('dcn', 'data', 'model') mesh and shards
the batch over ('dcn', 'data') jointly. The port runs one process per card,
so the batch axes are the processes: `dcn x data` must equal the running
world size, and the global batch is split into contiguous row blocks in
rank order, as the JAX package's per-process loading splits it. The
'model' axis (spatial W-sharding of the BEV grid) is not in the port.
"""

from __future__ import annotations

from typing import NamedTuple

from voxelnet_tpu_torch.parallel import distributed

W_SHARDING_MISSING = (
    "the port has no 'model' mesh axis yet: spatial W-sharding of the BEV "
    "grid is ROADMAP.md queue 1 item 17; set system.num_model_shards: 1")
LAUNCH = ("python -m torch.distributed.run --standalone --nproc_per_node {n} "
          "-m voxelnet_tpu_torch.cli.train --exp-dir <shared dir> ...")


class ProcessMesh(NamedTuple):
    """The batch axes of the config's mesh, mapped onto the processes."""

    world_size: int
    rank: int


def process_mesh(system) -> ProcessMesh:
    """`system` (config.SystemConfig) -> ProcessMesh of the running
    process group. Raises where the port cannot give the configured mesh:
    a 'model' axis above 1; a batch mesh above 1 with no process group up;
    a batch mesh whose size is not the world size."""
    if system.num_model_shards > 1:
        raise ValueError(f"system.num_model_shards="
                         f"{system.num_model_shards}: {W_SHARDING_MISSING}")
    n = system.num_dcn_shards * system.num_data_shards
    world = distributed.world_size()
    if n > 1 and not distributed.is_initialized():
        raise ValueError(
            f"system.num_dcn_shards x num_data_shards = {n} asks for {n} "
            "processes, one card each, but no torch.distributed process "
            f"group is up: launch them with `{LAUNCH.format(n=n)}` (or set "
            "VOXELNET_COORDINATOR, VOXELNET_NUM_PROCESSES and "
            "VOXELNET_PROCESS_ID in each), or set both to 1 for one process")
    if n != world:
        raise ValueError(
            f"system.num_dcn_shards x num_data_shards = {n}, but {world} "
            f"processes are running: launch `{LAUNCH.format(n=n)}`, or set "
            f"system.num_data_shards: {world} (with num_dcn_shards: 1)")
    return ProcessMesh(world_size=world, rank=distributed.rank())
