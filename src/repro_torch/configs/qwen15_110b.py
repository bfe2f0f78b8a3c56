"""dense 80L d8192 64H/kv8 ff49152 v152064 QKV-bias [hf:Qwen/Qwen1.5-110B]

Selectable via ``--arch qwen1.5-110b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "qwen1.5-110b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
