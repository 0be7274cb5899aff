"""Hand-written CUDA kernels (and their plain PyTorch versions) for the
port, with the wrappers that route keys to them."""
