"""Distribution layer of the port: sharding plans over meshes of virtual
devices or of ``(rank, device)`` pairs with a process group per axis
(``plan``), the reference's PartitionSpec rules as DTensor placements
(``sharding``), and the error-feedback int8 gradient compression of the
cross-pod exchange (``compression``)."""

from repro_torch.dist import compression, plan, sharding
from repro_torch.dist.plan import (Mesh, RankDevice, ShardingPlan, current_plan, rank_devices,
                                   use_plan)

__all__ = ["Mesh", "RankDevice", "ShardingPlan", "current_plan", "rank_devices", "use_plan",
           "plan", "sharding", "compression"]
