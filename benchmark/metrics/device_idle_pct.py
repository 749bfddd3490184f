"""device_idle_pct: the share of the traced window in which no kernel,
copy or memset ran on the card, in percent."""

from benchmark import tracing


def read(run):
    if run.events is None:
        return None
    busy = tracing.busy(run.events, run.span)
    if not busy:
        return None
    window = run.span[1] - run.span[0]
    return 100.0 * (1.0 - sum(b - a for a, b in busy) / window)
