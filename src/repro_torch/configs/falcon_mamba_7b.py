"""ssm 64L d4096 d_inner 8192 N16 conv4 v65024 Mamba-1 [arXiv:2410.05355]

Selectable via ``--arch falcon-mamba-7b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "falcon-mamba-7b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
