"""The Tip5 permutation and its batched hash entry points."""
