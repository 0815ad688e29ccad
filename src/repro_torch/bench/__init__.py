"""The paper's figures and tables on the PyTorch port, one module per
figure, and the benchmarks beside them (sweep engine, roofline, policy
space, fault masking, hedged serving): the twins of the JAX package's
``benchmarks/``; run them with ``python -m repro_torch.bench.run``."""
