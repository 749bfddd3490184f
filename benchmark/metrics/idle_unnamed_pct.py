"""idle_unnamed_pct: the share of the traced window in which the card was
idle and the host was in no program span (none of the program's
``align.*`` or ``batch.*`` steps, only the harness or nothing), in
percent: the card's waiting that no host step of the program names."""

from benchmark import idle


def read(run):
    gaps = idle.idle(run)
    if gaps is None:
        return None
    unnamed = (sum(b - a for a, b in gaps)
               - idle.overlap(gaps, idle.spans(run, idle.is_program)))
    return 100.0 * unnamed / (run.span[1] - run.span[0])
