"""Plain references the benchmark holds the program's output to: plain
PyTorch and NumPy, importing nothing of the program."""
