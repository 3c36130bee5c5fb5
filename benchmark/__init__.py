"""The benchmark of the PyTorch port: python3 -m benchmark.run (see run.py)."""
