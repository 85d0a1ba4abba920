"""Image transforms and the hand-written CUDA kernels of the read path."""
