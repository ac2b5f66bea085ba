"""Share of the device's busy time spent in the LSTM's kernels, the union
of their intervals over the union of all device intervals. Their names as
a traced run on the H100 shows them (cuDNN 9.22's standard LSTM, float32):
cuDNN's cell ``elemWiseRNNcell`` and the cuBLAS GEMV ``gemv2T_kernel_val``
of each step's recurrent matmul, 400 of each a request, and the two
``sm80_xmma_gemm_`` GEMMs of the directions' input projections (the
trunk's convolutions are ``*_fprop_implicit_gemm_*`` and ``fc_pose`` a
``cutlass_*_sgemm``)."""

KERNELS = ("elemWiseRNNcell", "gemv2T_kernel_val", "sm80_xmma_gemm_")


def read(window):
    if window.trace is None:
        return None
    share = window.trace.share_of_busy(KERNELS)
    return None if share is None else 100.0 * share
