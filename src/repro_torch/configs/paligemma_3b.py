"""vlm 18L d2048 8H/kv1 hd256 ff16384 v257216 SigLIP-stub + gemma prefix-LM [arXiv:2407.07726]

Selectable via ``--arch paligemma-3b`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "paligemma-3b"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
