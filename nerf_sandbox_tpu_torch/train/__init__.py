"""Checkpoint reading (the reading half of ``train/checkpoints.py``)."""
