"""One config module per ported architecture (``--arch <id>``).

Twin of ``repro.configs``: each model module gives ``NAME``, ``CONFIG``
and ``REDUCED``, one for each of the ten architectures of
:mod:`repro_torch.models.registry` (``get(name)``).  ``paper_occamy`` is
the paper's platform: the six jobs and Occamy's machine constants
(``CONFIG``).  ``SHAPES``, the cell table
of ``repro.launch.cells``, comes with the launch tools.
"""

from repro_torch.models.registry import ARCHS, get  # noqa: F401
