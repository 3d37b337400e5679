"""Detector training: optimizer, loop, checkpoints and the cached detector."""
