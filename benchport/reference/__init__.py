"""Plain references of the benchmark's configurations: NumPy, SciPy and
plain PyTorch only; nothing of the program under test."""
