"""Compute kernels: the stream scoring route (CUDA kernel and lax twins),
the segment lax route, the align-phase hint pass and NumPy oracles."""
