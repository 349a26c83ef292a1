"""Plain references of the benchmark's configurations: NumPy and PyTorch
only, never the program."""
