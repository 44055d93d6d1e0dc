"""Datasets and the numpy batch loader."""
