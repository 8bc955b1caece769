"""Hand-written Pallas kernels (GPU, Triton route)."""
