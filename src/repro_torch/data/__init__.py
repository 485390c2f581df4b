"""Synthetic data sources and the parallel loader (paper Alg. 1)."""
