"""cpy_host_ms: the program's ``align.cpy_host`` lap a call, in
milliseconds: the copy of the fill's outputs to the host in the
single-pair flow (its stopwatch, host clock after a synchronise)."""


def read(run):
    laps = [c.laps["align.cpy_host"] for c in run.calls
            if "align.cpy_host" in c.laps]
    if not laps:
        return None
    return sum(laps) / len(laps)
