"""Wrappers of the hand-written Hopper kernels, each beside its plain twin,
and the Merkle commit's launch plan."""
