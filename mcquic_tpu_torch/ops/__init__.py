"""Device ops: the VQ core and the wrappers of the hand-written kernels."""
