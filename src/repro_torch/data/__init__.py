"""Deterministic synthetic data with a hedged prefetcher."""
