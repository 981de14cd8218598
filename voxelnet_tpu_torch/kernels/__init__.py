"""The port's hand-written CUDA kernels: each wrapper module launches its
kernel for CUDA tensors and runs its plain torch version for CPU tensors,
and counts its launches. This package names the kernels, their sources and
the code of the JAX package each one replaces, and reads and resets the
wrappers' launch counts."""

from __future__ import annotations

from voxelnet_tpu_torch.kernels import (batch_norm, dense_build, run_copy,
                                        sparse_conv, vfe_fused)

# the CUDA sources under voxelnet_tpu_torch/csrc/, the source of each kernel
# not named after its own, and the code of the JAX package that each kernel
# replaces
SOURCES = ("vfe_fused", "dense_build", "run_copy", "sparse_conv",
           "batch_norm")
SOURCE = {"sparse_conv_grad": "sparse_conv", "occupancy_map": "sparse_conv",
          **dict.fromkeys(batch_norm.KERNELS, "batch_norm")}
REPLACES = {
    "vfe_fused": "voxelnet_tpu/kernels/vfe_fused.py:52",
    "dense_build": "voxelnet_tpu/kernels/dense_build.py:62",
    "run_copy": "voxelnet_tpu/kernels/voxelize_pallas.py:189 "
                "(_planar_t_kernel), :79 (_planar_kernel), :48 (_kernel)",
    # XLA code, no Pallas kernel: the 27 scatter-adds and their gradient
    "sparse_conv": "voxelnet_tpu/models/sparse_conv.py:92-108 (the 27 "
                   "scatter-adds)",
    "sparse_conv_grad": "voxelnet_tpu/models/sparse_conv.py:92-108 (the "
                        "gather of their autodiff)",
    "occupancy_map": "voxelnet_tpu/models/sparse_conv.py:92-108 (none: the "
                     "lookup the output-stationary sum needs; JAX scatters "
                     "instead)",
    # XLA code, no Pallas kernel: flax's nn.BatchNorm in train mode and
    # its autodiff (the ReLU after it and the cast fused in)
    **dict.fromkeys(batch_norm.KERNELS,
                    "voxelnet_tpu/models/{vfe,middle,rpn}.py (flax "
                    "nn.BatchNorm in train mode, XLA)"),
}
# each kernel's `__global__` symbol, the name CUPTI gives its launches
SYMBOLS = {"vfe_fused": "vfe_fused_kernel",
           "dense_build": "dense_build_kernel",
           "run_copy": "run_copy_kernel",
           "sparse_conv": "sparse_conv_fwd_kernel",
           "sparse_conv_grad": "sparse_conv_grad_kernel",
           "occupancy_map": "occupancy_kernel",
           **{k: f"{k}_kernel" for k in batch_norm.KERNELS}}
KERNELS = tuple(SYMBOLS)


def source_path(kernel: str) -> str:
    """The repo path of a kernel's CUDA source."""
    return f"voxelnet_tpu_torch/csrc/{SOURCE.get(kernel, kernel)}.cu"


def launch_counts() -> dict:
    """Each kernel's launches, as its wrapper counts them, since the last
    reset_launches()."""
    return {"vfe_fused": vfe_fused.launches,
            "dense_build": dense_build.launches,
            "run_copy": run_copy.launches,
            "sparse_conv": sparse_conv.launches,
            "sparse_conv_grad": sparse_conv.grad_launches,
            "occupancy_map": sparse_conv.occupancy_launches,
            **batch_norm.launches}


def reset_launches() -> None:
    vfe_fused.launches = dense_build.launches = run_copy.launches = 0
    sparse_conv.launches = sparse_conv.grad_launches = 0
    sparse_conv.occupancy_launches = 0
    batch_norm.launches.update(dict.fromkeys(batch_norm.KERNELS, 0))
