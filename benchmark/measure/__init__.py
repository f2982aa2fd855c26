"""Roofline counts, peaks and the reading of profiler traces."""
