"""Hopper counterparts of the JAX package's Pallas probes in ``scripts/``:
``pass_probe`` (an NTT local pass three ways) and ``alu_probe`` (chains of
one lazy field op), and the port's own: ``tip5_probe``, ``k3_probe``,
``fold_probe``, ``inv_probe`` (kernels by SASS, tile, lane target and
launch), ``merkle_probe`` and ``polynomial_probe`` (the Merkle tree's and
the polynomial engine's host routes against the card's) and
``dist_probe`` (the distributed NTT by world size, one rank a card,
kernel by kernel). Each runs as ``python -m twenty_first_tpu_torch.probes.<name>``
on a CUDA device and refuses to run without one."""
