"""hybrid 54L d2560 mamba2 sstate64 + shared 32H attn block every 6 [arXiv:2411.15242]

Selectable via ``--arch zamba2-2.7b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "zamba2-2.7b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
