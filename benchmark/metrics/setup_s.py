"""setup_s: seconds from the process's start to the first request of the
window: imports, the card's context, any build of the kernels, the pool
from the seed and one warm-up call of every request (host clock)."""


def read(run):
    return run.setup_s
