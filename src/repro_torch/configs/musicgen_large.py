"""audio 48L d2048 32H ff8192 v2048 decoder-only over EnCodec tokens, sinusoidal pos [arXiv:2306.05284]

Selectable via ``--arch musicgen-large`` in ``repro_torch.launch.serve``.
The exact configuration lives in :mod:`repro_torch.models.registry`; this
module re-exports it and its reduced smoke-test sibling.
"""

from repro_torch.models.config import reduced
from repro_torch.models.registry import get

NAME = "musicgen-large"
CONFIG = get(NAME)
REDUCED = reduced(CONFIG)
