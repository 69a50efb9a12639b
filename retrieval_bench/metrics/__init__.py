"""Metric readers, one module per metric, found by the metric's name in
``BENCHMARK.json``: ``metrics/<name>.py`` defines ``read(run) -> float |
None`` over a :class:`retrieval_bench.harness.Run`. A reader that finds
nothing to read returns ``None``, and the harness leaves the metric out."""
