"""Datasets, the numpy batch loader, the scene datasets and the chromatic
transforms (``chromatic.py``: imported by name, as the reference's
``data/__init__.py`` exports none of it)."""
