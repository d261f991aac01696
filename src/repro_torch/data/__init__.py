"""Synthetic data sets (counterpart of ``repro/data``)."""
