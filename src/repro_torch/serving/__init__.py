"""Serving: the baked artifact, the kernel datapath, dispatch and tracking,
and the fault-tolerant, durable fleet over them."""
