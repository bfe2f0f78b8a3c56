"""moe 27L d2048 16H ff1408 v102400 MLA kvlora512 2shared+64routed top-6 [arXiv:2405.04434]

Selectable via ``--arch deepseek-v2-lite-16b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "deepseek-v2-lite-16b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
