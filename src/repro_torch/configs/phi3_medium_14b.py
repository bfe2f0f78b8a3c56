"""dense 40L d5120 40H/kv10 ff17920 v100352 RoPE SwiGLU GQA [arXiv:2404.14219]

Selectable via ``--arch phi3-medium-14b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "phi3-medium-14b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
