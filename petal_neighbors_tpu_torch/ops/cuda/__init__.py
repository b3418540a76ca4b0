"""Hand-written CUDA kernels for Hopper, their plain versions, and the
builder that compiles them at first use."""
