"""The multi-GPU admission cycle: the conflict-domain planner
(domains.py, numpy only) and the mesh over torch.distributed with the
sharded cycle and the sharded preemption solve (mesh.py)."""
