"""kueue_tpu_torch: the PyTorch and CUDA port of kueue_tpu.

The fit-mode admission solve (cache snapshot -> encode -> the batched
solve -> decisions) runs on an NVIDIA H100 through hand-written CUDA
kernels (`solver/csrc`), with plain PyTorch versions of each kernel for
tensors on the CPU. The package imports torch and numpy, never JAX and
nothing of the JAX package `kueue_tpu`: it keeps its own copies of the
host modules its path needs (api, core, cache, flavor assignment,
encode).

Entry points take `device=None`, which means the card; pass
`device="cpu"` for the plain versions.
"""

__version__ = "0.1.0"
