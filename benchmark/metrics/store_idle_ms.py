"""store_idle_ms: the card's idle time inside the single-pair flow's
``align.store`` spans (the tile-major header copies and the last tile's
recompute on the host), in milliseconds a traced call."""

from benchmark import idle


def read(run):
    return idle.idle_inside_ms(run, "align.store")
