"""dense 32L d960 15H/kv5 ff2560 v49152 llama-arch small [hf:HuggingFaceTB/SmolLM-360M]

Selectable via ``--arch smollm-360m`` in ``repro_torch.launch.serve``.  The
exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "smollm-360m"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
