"""One config module per ported architecture (``--arch <id>``).

Twin of ``repro.configs``: each model module gives ``NAME``, ``CONFIG``
and ``REDUCED``.  The port serves the dense, moe (GQA or MLA), ssm and
hybrid families so far, so only architectures of those have a module here
(smollm-360m, yi-9b, phi3-medium-14b, qwen1.5-110b, deepseek-v2-lite-16b,
llama4-scout-17b-a16e, falcon-mamba-7b, zamba2-2.7b);
every configuration is in :mod:`repro_torch.models.registry`
(``get(name)``).  ``paper_occamy`` is the paper's platform: the six jobs
and Occamy's machine constants (``CONFIG``).  ``SHAPES``, the cell table
of ``repro.launch.cells``, comes with the launch tools.
"""

from repro_torch.models.registry import ARCHS, get  # noqa: F401
