"""The 1D-F-CNN detector configuration and its parameters."""
