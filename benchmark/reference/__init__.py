"""The benchmark's plain reference of EgoNN and MinkLoc3D: quantization, the
coordinate pyramid and its gather maps, the models, the losses and Adam, in
plain PyTorch (f32; the caller turns TF32 off).  It imports nothing of the
program under test: it is a frozen, simplified copy of the port's plain
paths (the CUDA kernels' plain versions, no bf16, no data parallelism, no
fused epilogues), so that a later change to the program cannot move it.
"""
