"""The atlas store — counterpart of :mod:`qba_tpu.atlas` (its store
only; the campaign runner, `atlas/campaign.py`, waits for ROADMAP
A15)."""
