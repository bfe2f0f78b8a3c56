"""moe 48L d5120 40H/kv8 ff8192 v202048 16e top-1 + shared [hf:meta-llama/Llama-4-Scout-17B-16E]

Selectable via ``--arch llama4-scout-17b-a16e`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "llama4-scout-17b-a16e"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
