"""The batched admission solve on the card.

- encode.py: snapshot -> padded numpy arrays (host)
- kernel.py: the CUDA kernels' wrappers (csrc/) and their plain PyTorch
  versions: the fit cycle and the minimal-preemption solve
- candidates.py, preempt.py: the preemption problems' candidate index,
  encode and target decode (host)
- service.py: BatchSolver, from a snapshot and the cycle's heads to
  decoded assignments, and a preemption batch to its targets, on one
  device or sharded over a mesh (kueue_tpu_torch/parallel)
"""

from kueue_tpu_torch.solver.service import BatchSolver  # noqa: F401
