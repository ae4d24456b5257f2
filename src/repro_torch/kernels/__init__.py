"""Hand-written CUDA kernels for Hopper (sm_90a), their plain PyTorch
versions, and the adapters the index calls."""
