"""Hand-written CUDA kernels of the PyTorch port, each beside its plain
PyTorch version (``ref.py``) and its dispatch (``ops.py``)."""
