"""Sharding plans on a ``torch.distributed`` ``DeviceMesh`` (the port of
``repro.distributed``)."""
from .sharding import (  # noqa: F401
    MeshShape,
    ShardingPlan,
    make_plan,
    spec_to_sharding,
)
