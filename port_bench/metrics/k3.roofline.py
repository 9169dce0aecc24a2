"""K3's share of its roofline: the least time of the operations' NTTs and
the coset scaling (roofline.ntt_work) over the summed device time of K3's
passes in the traced window. A transform of two passes reaches at most
half of it: its bytes are counted once."""

import roofline

#: kernel name pattern -> the port's launch counter (module:wrapper)
KERNELS = {r"\bntt_local_pass_kernel<": "twenty_first_tpu_torch.ops.ntt_cuda:ntt_local_pass"}


def read(window):
    nbytes, imads = roofline.ntt_work(window.work)
    if not nbytes:
        return None
    least, _ = roofline.least_seconds(nbytes * window.ops, imads * window.ops)
    return roofline.share(least, window.device_seconds(KERNELS))
