"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Importing this package builds nothing: `backend.kernel_library`
compiles a kernel's source the first time a CUDA tensor reaches it."""
