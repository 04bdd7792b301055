"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Importing a module here builds nothing: a kernel is compiled with
nvcc at its first launch (see ``build``)."""
