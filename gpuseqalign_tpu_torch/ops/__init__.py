from . import batch_cuda, batch_plain, mlsp_cuda, mlsp_kernels, mlsp_plain

__all__ = ["batch_cuda", "batch_plain", "mlsp_cuda", "mlsp_kernels",
           "mlsp_plain"]
