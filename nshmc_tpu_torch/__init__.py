"""nshmc_tpu_torch — the PyTorch/CUDA port of nshmc_tpu for NVIDIA Hopper.

Noise-space HMC for diffusion inverse problems, written in PyTorch for one
H100 (sm_90a). Module names mirror the JAX package `nshmc_tpu`, which stays
the numerical reference; each Pallas TPU kernel on the ported path has a
hand-written Hopper kernel in `ops/` (CUDA C++ sources under `csrc/`, or
Triton) next to a plain PyTorch version of the same function. The plain
version serves CPU tensors only; on CUDA the kernel runs or raises.

Entry point: `python -m nshmc_tpu_torch.cli` (runs on `cuda` unless
`--device cpu` is given).
"""

__version__ = "0.1.0"
