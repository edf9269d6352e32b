"""Metric readers, one file each, named as the metric in BENCHMARK.json:
`read(ctx)` returns the metric's value from the run's context (see
run.py::Context), or None where the run gives it nothing to read; the
harness then leaves the metric out of the result line."""
