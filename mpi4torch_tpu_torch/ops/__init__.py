"""Operators: collectives, attention (CUDA kernel and plain version)
and static-shape masks."""
