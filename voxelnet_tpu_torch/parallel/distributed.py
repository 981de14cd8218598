"""Several processes, one card each: the port's counterpart of
`voxelnet_tpu/parallel/distributed.py`.

The JAX step is one program over the global batch that a mesh only places;
here every process runs the same step on its part of the global batch, and
the places where the parts meet are collectives, each over a `Group` of
processes (parallel/mesh.py lays the groups out):

  * `all_reduce_in_place`: the BatchNorm statistics of train mode and
    their gradient's sums, one SUM all-reduce each way a call
    (models/bn.py);
  * `all_reduce_` on one flat buffer: the gradient and the metric vector
    of the train and eval steps (training/train_step.py). The loss is a
    sum over frames, so the global gradient is the SUM of the processes'
    gradients, not their mean;
  * the halo exchanges and the gather of a W-sharded grid
    (parallel/spatial.py), over a model group;
  * `broadcast_state_`: the model's parameters and buffers and the
    optimizer's momentum trace from rank 0, after init and after a
    restore;
  * `barrier`: after rank 0 writes a checkpoint.

Only all_reduce, broadcast and barrier are used: gloo has them for CUDA
tensors too, so two ranks can share one card over gloo where NCCL refuses
("Duplicate GPU detected"). Without a process group, or over a group of
one, every helper is the identity (a mesh of size 1 is free).
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

# the JAX CLI's launch variables (voxelnet_tpu/parallel/distributed.py)
ENV_COORDINATOR = "VOXELNET_COORDINATOR"
ENV_NUM_PROCESSES = "VOXELNET_NUM_PROCESSES"
ENV_PROCESS_ID = "VOXELNET_PROCESS_ID"
DEFAULT_TIMEOUT_S = 600.0

# the all-reduces this process issued, by the name of the group they ran
# over: [count, payload bytes]; read by the caller and cleared by
# reset_counts(), as the kernels' launch counts are
all_reduce_counts: dict[str, list[int]] = {}
# the torch process groups of make_group, by their ranks
_handles: dict[tuple[int, ...], object] = {}


class Group(NamedTuple):
    """The processes a collective runs over: a name for the counters and
    the ranks, ascending. The torch process group behind it is made once
    by make_group (or is the world's), so a Group can be copied and
    pickled."""

    name: str
    ranks: tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.ranks)

    def index(self) -> int:
        """This process's position in the group."""
        return self.ranks.index(rank())


def world_group() -> Group:
    return Group("world", tuple(range(world_size())))


def make_group(name: str, ranks) -> Group:
    """A Group of `ranks`. Its torch process group is made at the first
    call for those ranks: every process must make every group, members or
    not, in the same order (torch.distributed.new_group)."""
    ranks = tuple(sorted(ranks))
    if len(ranks) > 1 and ranks not in _handles:
        _handles[ranks] = dist.new_group(list(ranks))
    return Group(name, ranks)


def reset_counts() -> None:
    all_reduce_counts.clear()


def launched() -> bool:
    """True when the environment names a multi-process launch: the JAX
    CLI's VOXELNET_COORDINATOR or torchrun's WORLD_SIZE."""
    return ENV_COORDINATOR in os.environ or "WORLD_SIZE" in os.environ


def launch_world_size() -> int:
    """The process count the environment asks for (1 when none)."""
    for key in (ENV_NUM_PROCESSES, "WORLD_SIZE"):
        if key in os.environ:
            return int(os.environ[key])
    return 1


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Start the process group of this process and return its device.

    The group's address, size and rank come from the arguments; else from
    VOXELNET_COORDINATOR (host:port, or any torch init URL such as
    file://...) / VOXELNET_NUM_PROCESSES / VOXELNET_PROCESS_ID; else from
    torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK. The device is
    `device`, else cuda:LOCAL_RANK (LOCAL_RANK, or the rank modulo the
    card count); without a card `device` must be given ("cpu"): a
    process that meant to train on a card does not fall back to the CPU
    unseen. The backend is
    `backend`, else nccl for a CUDA device and gloo for the CPU. A rank
    that waits `timeout_s` seconds on a collective fails instead of
    hanging."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(ENV_COORDINATOR)
    if coordinator_address is not None:
        if num_processes is None:
            num_processes = int(env[ENV_NUM_PROCESSES])
        if process_id is None:
            process_id = int(env[ENV_PROCESS_ID])
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    else:
        init_method = "env://"
        num_processes = (int(env["WORLD_SIZE"]) if num_processes is None
                         else num_processes)
        process_id = int(env["RANK"]) if process_id is None else process_id
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "distributed.initialize(device=None) picks a card, and torch "
                "sees none: pass device='cpu' (with the gloo backend) to run "
                "this process on the CPU")
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shutdown() -> None:
    """Destroy the process group and the groups made in it, if one is
    up."""
    _handles.clear()
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def all_reduce_in_place(t: torch.Tensor, group: Group) -> None:
    """SUM all-reduce of the contiguous `t` over `group`, counted. Every
    process of the world calls it only where every member of the group
    does, in the same order."""
    counts = all_reduce_counts.setdefault(group.name, [0, 0])
    counts[0] += 1
    counts[1] += t.numel() * t.element_size()
    if group.size == world_size():
        dist.all_reduce(t)
        return
    if group.ranks not in _handles:
        raise RuntimeError(f"group {group.name} {group.ranks} was not made "
                           "in this process group (distributed.make_group)")
    dist.all_reduce(t, group=_handles[group.ranks])


def all_reduce_(tensors: list[torch.Tensor],
                group: Group | None = None) -> list[torch.Tensor]:
    """The SUM over `group` (default the world) of each tensor, through one
    all-reduce of their flat concatenation (all of one dtype). Returns new
    tensors (the inputs themselves over a group of one)."""
    group = group or world_group()
    if group.size == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_in_place(flat, group)
    return [part.view_as(t) for part, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]


def _state_tensors(model: torch.nn.Module, opt_state) -> list[torch.Tensor]:
    """The model's parameters and buffers, then the optimizer state's
    momentum trace (training/optim.OptState) when it has one."""
    tensors = list(model.parameters()) + list(model.buffers())
    if opt_state is not None and opt_state.trace is not None:
        tensors += list(opt_state.trace)
    return tensors


@torch.no_grad()
def broadcast_state_(model: torch.nn.Module, opt_state=None,
                     src: int = 0) -> None:
    """Copy `src`'s parameters and buffers, and the momentum trace of
    `opt_state` (training/optim.OptState), into every process's, in place.
    The update count is the same on every process by construction (every
    rank restores the same checkpoint step)."""
    if world_size() == 1:
        return
    for t in _state_tensors(model, opt_state):
        dist.broadcast(t.data, src)


@torch.no_grad()
def ranks_disagree(model: torch.nn.Module, opt_state=None) -> int:
    """The number of processes whose parameters and buffers (and momentum
    trace of `opt_state`) are not bit-equal to rank 0's (0 in a world of
    one)."""
    if world_size() == 1:
        return 0
    differ = torch.zeros((), dtype=torch.float64,
                         device=next(model.parameters()).device)
    for t in _state_tensors(model, opt_state):
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        if not torch.equal(ref, t.detach()):
            differ.fill_(1.0)
    dist.all_reduce(differ)
    return int(differ.item())
