// K3's order modes (ntt_pass.cuh): the kernels that read a column in
// bit-reversed row order (k3::kRevIn) or write it so (k3::kRevOut), each
// for 2^1..2^4 elements a thread, without a second diagonal. Launched by
// ntt.cu's tf_ntt_local_pass; a translation unit of their own so that nvcc
// builds them beside the natural passes.
#include "ntt_pass.cuh"

const void* k3::order_kernel(int log_r, int order) {
  return order == kRevIn ? kernel_for<false, kRevIn>(log_r)
                         : kernel_for<false, kRevOut>(log_r);
}
