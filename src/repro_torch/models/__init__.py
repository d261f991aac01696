"""The kanformer decoder in PyTorch (counterpart of ``repro.models``)."""
