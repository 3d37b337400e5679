"""Serving: the baked artifact, the kernel datapath, dispatch and tracking."""
