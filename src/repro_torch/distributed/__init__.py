"""Sharding plans on a ``torch.distributed`` ``DeviceMesh`` (the port of
``repro.distributed``)."""
from .sharding import (  # noqa: F401
    Block,
    MeshShape,
    RankView,
    ShardingPlan,
    make_plan,
    rank_view,
    spec_to_sharding,
)
