"""Device operations; each module that holds a CUDA kernel keeps its plain
PyTorch version beside it."""
