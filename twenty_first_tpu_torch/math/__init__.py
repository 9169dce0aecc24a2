"""Goldilocks field arithmetic and the NTT on the int64 carrier."""
