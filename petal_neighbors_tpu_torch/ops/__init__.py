"""Exact k-NN operations: top-k primitives, the brute-force routes."""
