"""The yardstick: cell discovery, traffic, operands, work counts, peaks,
the closed-loop drivers, the profiler window and the output check."""
