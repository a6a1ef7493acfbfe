"""The plain reference of the benchmark: PyTorch only, nothing of the
program (whitted.py renders, fit.py takes the fit's steps)."""
