"""Serving: the static and continuous greedy engines, the paged KV pool and
the prefix cache (counterpart of ``repro.serve``)."""
