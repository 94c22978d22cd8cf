"""Multi-process estimation: the landmark-sharded window BA over
torch.distributed (dist_ba)."""
