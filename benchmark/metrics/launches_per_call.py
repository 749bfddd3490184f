"""launches_per_call: CUDA kernels that started in the traced window, over
the calls of that window: the fill launches and every other kernel the
program runs, such as the padding of a bucket on the card."""

from benchmark import tracing


def read(run):
    if run.events is None or not run.traced:
        return None
    kernels = tracing.inside(run.events, ("kernel",), run.span)
    if not kernels:
        return None
    return len(kernels) / run.traced
