"""B-spline math and KAN layers (counterpart of ``repro.core``)."""
