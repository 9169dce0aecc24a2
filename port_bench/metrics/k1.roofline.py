"""K1's share of its roofline: the least time of the operations' leaf
hashes and sponge absorbs (roofline.hash_work) over K1's summed device
time in the traced window."""

import roofline

#: kernel name pattern -> the port's launch counter (module:wrapper)
KERNELS = {r"\btip5_permute_kernel<0>": "twenty_first_tpu_torch.ops.tip5_cuda:tip5_permute"}


def read(window):
    nbytes, imads = roofline.hash_work(window.work)
    least, _ = roofline.least_seconds(nbytes * window.ops, imads * window.ops)
    return roofline.share(least, window.device_seconds(KERNELS))
