"""Studies of the port's kernels that run on the CPU."""
