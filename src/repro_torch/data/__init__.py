"""Deterministic synthetic data pipeline (twin of ``repro.data``).

Batch ``i`` is a pure function of (seed, i), in numpy only, so both
packages see bit-identical prompts.  ``input_specs`` comes with the
dry-run tools.
"""

from repro_torch.data.pipeline import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]
