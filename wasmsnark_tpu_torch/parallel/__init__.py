"""Multi-rank sharding over torch.distributed (parallel/mesh.py)."""
