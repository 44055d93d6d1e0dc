"""The ULIP composite model and its factories."""
