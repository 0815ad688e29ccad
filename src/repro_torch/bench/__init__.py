"""The paper's figures and tables on the PyTorch port, one module per
figure (the twins of the JAX package's ``benchmarks/``); run them with
``python -m repro_torch.bench.run``."""
