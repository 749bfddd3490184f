"""host_prep_ms: the batch engine's host steps a call, in milliseconds:
the summed duration of the program's ``batch.bucket_pairs`` and
``batch.stack_bucket`` spans in the traced window, over its calls."""

from benchmark import tracing

SPANS = ("batch.bucket_pairs", "batch.stack_bucket")


def read(run):
    if run.events is None or not run.traced:
        return None
    spans = [e for e in tracing.inside(run.events, ("user_annotation",),
                                       run.span) if e["name"] in SPANS]
    if not spans:
        return None
    return sum(e["dur"] for e in spans) * 1e-3 / run.traced
