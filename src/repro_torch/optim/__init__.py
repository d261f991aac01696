"""The optimizer (counterpart of ``repro/optim``)."""
