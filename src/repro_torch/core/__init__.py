"""Numeric modes, quantisers, pruning and the per-layer precision policy."""
