"""The plain reference the benchmark judges the program by: SciPy and
NumPy only, nothing of the program."""
