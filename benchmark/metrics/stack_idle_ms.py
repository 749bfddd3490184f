"""stack_idle_ms: the card's idle time inside the batch engine's
``batch.stack_bucket`` spans (the pinned host buffer, its copy and the
padding on the card, ``batch.pad_rows``), in milliseconds a traced
call."""

from benchmark import idle


def read(run):
    return idle.idle_inside_ms(run, "batch.stack_bucket")
