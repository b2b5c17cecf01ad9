"""Metrics of the port: the structured profiler (metrics/profiler.py)."""
