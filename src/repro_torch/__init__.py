"""PyTorch/CUDA port of the Cortex reproduction.

Mirrors ``src/repro``'s layout module for module. The port imports
``torch`` and numpy only. Stage 1 of the semantic-cache lookup runs on
hand-written CUDA kernels (``kernels/csrc/ann_topk*.cu``) and the LM
stack's attention on two more (``kernels/csrc/flash_attention.cu``,
``decode_attention.cu``) when the tensors live on a CUDA device, and on
the kernels' plain PyTorch versions when they live on the CPU.
"""
