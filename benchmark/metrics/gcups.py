"""gcups: live DP cells of every call completed in the window over the
window's seconds, in billions a second (host clock)."""


def read(run):
    cells = sum(run.cells[c.item] for c in run.calls if c.answers is not None)
    return cells / run.window_s / 1e9
