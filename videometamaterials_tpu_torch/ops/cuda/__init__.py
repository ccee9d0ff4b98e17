"""Hand-written sm_90a kernels of the port, each with a plain PyTorch twin.

A wrapper launches its kernel for a CUDA tensor (or raises) and calls the
twin for a CPU tensor; nothing is imported from triton or built at import
time (see _build.py)."""
