"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions (``ref``), the nvcc build (``build``) and the wrappers (``ops``)."""
