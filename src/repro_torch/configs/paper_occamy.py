"""The paper's own evaluation platform: Occamy (§3.1) — 1 CVA6 host +
8 quadrants × 4 clusters × (8 compute + 1 DMA) Snitch cores, and the six
benchmark kernels of §5.1 with the measured machine constants of §5.5.
"""

from repro_torch.core.jobs import PAPER_JOBS  # noqa: F401
from repro_torch.core.params import DEFAULT_PARAMS, OccamyParams  # noqa: F401

NAME = "occamy"
CONFIG = DEFAULT_PARAMS
assert CONFIG.num_clusters == 32
assert CONFIG.num_cores == 32 * 9 + 1   # 289 incl. the CVA6 host
