"""Plain references of the benchmark's configurations: NumPy and PyTorch
only, designed again from each configuration file."""
