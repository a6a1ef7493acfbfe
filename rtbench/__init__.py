"""The benchmark of the PyTorch and CUDA port (``python3 rtbench/run.py``)."""
