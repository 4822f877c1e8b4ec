"""Hand-written GPU kernels for the hot path (Pallas, Triton route)."""
