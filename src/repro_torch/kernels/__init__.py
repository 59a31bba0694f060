"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain
PyTorch versions (``ref``) and the device-dispatching wrappers (``ops``)."""
