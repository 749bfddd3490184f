from . import mlsp_cuda, mlsp_kernels, mlsp_plain

__all__ = ["mlsp_cuda", "mlsp_kernels", "mlsp_plain"]
