"""The LM train step (counterpart of ``repro/train``)."""
