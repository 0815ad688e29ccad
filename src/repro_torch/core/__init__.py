"""Scenario specs, distributions, the cell plan, the sweep engine and the
threshold estimators of the PyTorch port."""
