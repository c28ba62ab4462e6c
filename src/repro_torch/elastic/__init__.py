"""Elastic data-parallel scaling: co-adapt the device footprint with the
DiveBatch batch size.

Counterpart of ``repro/elastic``.  ``ladder.MeshLadder`` is an ordered family
of plans over nested sub-meshes (dp widths 1 -> D); ``rung_for_batch(m)``
picks the widest rung whose dp width keeps the per-device microbatch >= the
granule.  ``reshard.reshard`` moves the full ``TrainState``, or a served
model, between rungs (a strict no-op on an unchanged rung); ``place`` is
the restore-time variant.  The ``StepEngine`` keys its steps by (bucket,
tier, rung), and the ``Trainer`` and the ``ServeEngine`` make the rung
transition at the boundary that resizes the batch.
"""

from repro_torch.elastic.ladder import MeshLadder, Rung
from repro_torch.elastic.reshard import place, reshard, same_plan

__all__ = ["MeshLadder", "Rung", "place", "reshard", "same_plan"]
