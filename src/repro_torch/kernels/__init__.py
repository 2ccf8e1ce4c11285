"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version. Dispatch goes by the tensor's device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises."""
