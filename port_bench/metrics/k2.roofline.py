"""K2's share of its roofline: the least time of the operations' Merkle
trees (roofline.tree_work) over the summed device time of K2's launches,
its full-width levels (leaf and pair modes) and its fused tail, in the
traced window."""

import roofline

_COUNTERS = "twenty_first_tpu_torch.ops.tip5_cuda:"
#: kernel name pattern -> the port's launch counter (module:wrapper)
KERNELS = {
    r"\btip5_permute_kernel<2>": _COUNTERS + "merkle_level",
    r"\btip5_permute_kernel<3>": _COUNTERS + "merkle_level",
    r"\bmerkle_commit_kernel\b": _COUNTERS + "merkle_commit",
}


def read(window):
    nbytes, imads = roofline.tree_work(window.work)
    least, _ = roofline.least_seconds(nbytes * window.ops, imads * window.ops)
    return roofline.share(least, window.device_seconds(KERNELS))
