"""Serving helpers — counterpart of :mod:`qba_tpu.serve` (the file
helpers only; the worker waits for ROADMAP A10)."""
