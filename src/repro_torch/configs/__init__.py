"""One config module per ported architecture (``--arch <id>``).

Twin of ``repro.configs``: each module gives ``NAME``, ``CONFIG`` and
``REDUCED``.  The port serves the dense and ssm families so far, so only
architectures of those have a module here; every configuration is in
:mod:`repro_torch.models.registry` (``get(name)``).  ``SHAPES``, the cell
table of ``repro.launch.cells``, comes with the launch tools.
"""

from repro_torch.models.registry import ARCHS, get  # noqa: F401
