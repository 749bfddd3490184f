"""search_issue_ms: the host's cost to issue a database search, in
milliseconds a traced call: the summed duration of the program's
``db.query``, ``db.fill``, ``db.tiny`` and ``db.copy_back`` spans in the
traced window (the query's copy and every bucket's launches, up to the
answers' copy back; not the wait), over its calls."""

from benchmark import tracing

SPANS = ("db.query", "db.fill", "db.tiny", "db.copy_back")


def read(run):
    if run.events is None or not run.traced:
        return None
    spans = [e for e in tracing.inside(run.events, ("user_annotation",),
                                       run.span) if e["name"] in SPANS]
    if not spans:
        return None
    return sum(e["dur"] for e in spans) * 1e-3 / run.traced
