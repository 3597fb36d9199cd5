"""The batched admission solve on the card.

- encode.py: snapshot -> padded numpy arrays (host)
- kernel.py: the fit-mode cycle: the avail / phase_a / phase_b / pack
  CUDA kernels (csrc/), their plain PyTorch versions and the library
  sort of the admit order
- service.py: BatchSolver, from a snapshot and the cycle's heads to
  decoded assignments
"""

from kueue_tpu_torch.solver.service import BatchSolver  # noqa: F401
