"""Deterministic synthetic data pipeline (twin of ``repro.data``).

Batch ``i`` is a pure function of (seed, i), in numpy only, so both
packages see bit-identical prompts.  ``input_specs`` gives ``meta``-device
stand-ins for every model input of a cell (the reference's
``ShapeDtypeStruct``s), for the train step's batch specs.
"""

from repro_torch.data.pipeline import DataConfig, SyntheticStream, input_specs

__all__ = ["DataConfig", "SyntheticStream", "input_specs"]
