"""Distribution layer (twin of ``repro.dist``): the sharding rules over a
logical mesh, and gradient compression over a logical data axis."""

from repro_torch.dist.sharding import (  # noqa: F401
    LogicalMesh,
    batch_specs,
    cache_specs,
    dp_axes,
    param_specs,
)
