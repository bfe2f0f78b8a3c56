"""dense 48L d4096 32H/kv4 ff11008 v64000 llama-arch GQA [arXiv:2403.04652]

Selectable via ``--arch yi-9b`` in ``repro_torch.launch.serve``.  The exact
configuration lives in :mod:`repro_torch.models.registry`; this module
re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "yi-9b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
