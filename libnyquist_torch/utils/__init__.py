"""Measurement helpers of the port: the stage profiler, operation and
byte counters, the card's published peaks and trace capture
(``profiling.py``)."""
