"""Gradient wire formats (the part of ``repro/dist`` the train step needs)."""
