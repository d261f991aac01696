"""Serving: the static greedy engine (counterpart of ``repro.serve``)."""
