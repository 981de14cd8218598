"""voxelnet_tpu_torch — the PyTorch/CUDA port of voxelnet_tpu for one NVIDIA
H100: the Car inference path (voxelize -> fused VFE -> dense grid -> Conv3D
middle -> RPN -> decode -> rotated NMS), with hand-written CUDA kernels for
the fused VFE and the dense-grid build. Imports torch, never JAX."""

__version__ = "0.1.0"
