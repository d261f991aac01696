"""Hand-written CUDA kernels for the KAN layers, with their plain PyTorch
versions (counterpart of ``repro.kernels``).  Importing this package builds
nothing: a kernel is compiled at its first launch on a CUDA tensor."""
