"""PyTorch/CUDA port of the Cortex reproduction.

Mirrors ``src/repro``'s layout module for module. The port imports
``torch`` and numpy only; stage 1 of the semantic-cache lookup runs on a
hand-written CUDA kernel (``kernels/csrc/ann_topk.cu``) when the index
lives on a CUDA device, and on the kernel's plain PyTorch version when
it lives on the CPU.
"""
