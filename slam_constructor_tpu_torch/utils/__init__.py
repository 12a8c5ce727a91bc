"""Synthetic data, evaluation and state conversion for the port."""
