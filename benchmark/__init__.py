"""The PyTorch and CUDA port's benchmark: `python3 benchmark/run.py` (see README.md)."""
