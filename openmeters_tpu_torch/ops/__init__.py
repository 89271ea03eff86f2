"""Streaming DSP building blocks and the CUDA kernels of the port."""
