"""fill_roofline: the roofline bound of every call in the traced
window (``roofline.bound_s``: the work the answers need) over the summed
device time of every CUDA kernel that started in it, in percent."""

from benchmark import tracing


def read(run):
    if run.events is None:
        return None
    kernels = tracing.inside(run.events, ("kernel",), run.span)
    kernel_s = sum(e["dur"] for e in kernels) * 1e-6
    if kernel_s <= 0:
        return None
    bound = sum(run.bound_s[c.item] for c in run.traced_calls)
    return 100.0 * bound / kernel_s
