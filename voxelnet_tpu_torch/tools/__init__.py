"""Runnable tools of the port (python -m voxelnet_tpu_torch.tools.<name>)."""
