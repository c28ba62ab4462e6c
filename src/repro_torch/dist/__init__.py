"""Distribution layer of the port: sharding plans over virtual-device meshes
(``plan``) and the error-feedback int8 gradient compression of the
cross-pod exchange (``compression``)."""

from repro_torch.dist import compression, plan
from repro_torch.dist.plan import Mesh, ShardingPlan, current_plan, use_plan

__all__ = ["Mesh", "ShardingPlan", "current_plan", "use_plan", "plan", "compression"]
