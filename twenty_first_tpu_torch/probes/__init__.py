"""Hopper counterparts of the JAX package's Pallas probes in ``scripts/``:
``pass_probe`` (an NTT local pass three ways) and ``alu_probe`` (chains of
one lazy field op). Each runs as ``python -m twenty_first_tpu_torch.probes.<name>``
on a CUDA device and refuses to run without one."""
