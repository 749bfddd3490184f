"""One file a metric, named as in BENCHMARK.json: ``read(run)`` returns the
metric's value from a ``harness.Run``, or None where it finds nothing to
read (the harness then leaves the metric out of the line)."""
