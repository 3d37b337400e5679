"""Hand-written Hopper kernels (K1-K3b and the front-end's fixed-order
primitives), their plain PyTorch twins and the device rule that picks
between them."""
