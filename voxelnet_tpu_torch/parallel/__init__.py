"""Data parallelism of the port: one process per card over
torch.distributed (distributed.py), and the config's mesh mapped onto the
processes (mesh.py)."""
