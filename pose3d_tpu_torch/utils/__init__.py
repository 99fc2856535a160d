"""Helpers outside the models: the renders (``visualize.py``)."""
