"""Attention ops and the hand-written kernels under them."""
