"""Checkpointing substrate (twin of ``repro.checkpoint``): npz + manifest,
atomic, elastic, in the reference's file format."""
from repro_torch.checkpoint.store import latest_step, restore, save
__all__ = ["latest_step", "restore", "save"]
