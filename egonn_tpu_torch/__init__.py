"""PyTorch / CUDA port of egonn_tpu for NVIDIA Hopper (H100).

The JAX package `egonn_tpu` is the reference; this package imports none of
it, nor JAX.  Entry point: `egonn_tpu_torch.inference.forward` on a model
from `egonn_tpu_torch.models.factory.create_egonn_model`, on CUDA unless the
caller passes `device="cpu"`.  The sparse-conv kernels are hand-written CUDA
C++ (`csrc/`), built by nvcc at first use (`sparse/cuda_lib.py`).
"""
