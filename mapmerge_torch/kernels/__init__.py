"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel module holds the wrapper (plain version for a CPU tensor, the
kernel or an error for a CUDA tensor), the plain version, and a
`build.Kernel` record with the launch count.
"""
