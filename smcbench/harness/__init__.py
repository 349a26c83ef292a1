"""The benchmark's general parts: the cell's files, the closed-loop
window, the arithmetic of the metrics, the profiler's trace, kernel
timing and the checks that decide ``correct``."""
