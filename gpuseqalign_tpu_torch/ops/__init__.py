from . import (batch_cuda, batch_plain, dense_cuda, dense_kernels,
               dense_plain, mlsp_cuda, mlsp_kernels, mlsp_plain, skew,
               wavefront, wavefront_cuda, wavefront_plain)

__all__ = ["batch_cuda", "batch_plain", "dense_cuda", "dense_kernels",
           "dense_plain", "mlsp_cuda", "mlsp_kernels", "mlsp_plain", "skew",
           "wavefront", "wavefront_cuda", "wavefront_plain"]
