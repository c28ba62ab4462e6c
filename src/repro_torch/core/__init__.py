"""DiveBatch core: gradient-diversity estimation (``diversity``), the
batch policies (a copy of ``repro.core.batch_policy``), and the lr rules
with the legacy ``AdaptiveBatchController`` shim (``controller``)."""
