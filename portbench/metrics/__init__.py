"""One reader a per-layer metric, found by its name in BENCHMARK.json.

``read(trace)`` takes the traced run (trace.Trace) and returns the
metric's value, or None where the run holds nothing to read.
"""
