"""Scenario specs, distributions, the cell plan, the sweep engine, the
threshold estimators and the paper's empirical systems (storage, DNS,
the fat-tree packet simulator, the TCP model) of the PyTorch port."""
