"""Hand-written CUDA kernels of the port (sources under `csrc/`, built with
nvcc at first use by `_build`, bound with ctypes).

`frontend.logmel_prefix` replaces frame→window→FFT→|·|²→mel→log(+energy)
with one kernel; its plain version is `frontend.logmel_prefix_reference`.
Modules here never import triton or build anything at import time.
"""
