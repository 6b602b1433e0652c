"""Plain references of what the benchmark checks (PyTorch and NumPy only)."""
