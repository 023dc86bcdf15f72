"""Device ops: the log-mel frontend, its CUDA kernel and the kernel builder."""
