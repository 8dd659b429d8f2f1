"""Hand-written CUDA kernels for Hopper (sources in ../csrc), their ctypes
wrappers and the nvcc build."""
