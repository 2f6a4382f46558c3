"""Hand-written CUDA kernels, their build, and the device helper."""
