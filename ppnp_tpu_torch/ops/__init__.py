"""Operators: Â normalization, sparse formats, propagation, sparse fc1."""
