"""PyTorch/CUDA port of `pixelnerf_tpu` for one NVIDIA Hopper GPU.

The package mirrors the JAX package's layout module for module. Plain
tensor code is PyTorch; each Pallas kernel on a ported path is a kernel
written by hand for Hopper (CUDA C++ under `csrc/`, or Triton), with a
plain PyTorch version beside it that serves CPU tensors.

Entry points (`models.pixelnerf.make_model`) place the model on CUDA
unless the caller passes `device="cpu"`; without a GPU and without an
explicit device they raise instead of running on the CPU.
"""

from pixelnerf_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
