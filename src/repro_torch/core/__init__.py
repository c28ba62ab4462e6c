"""Host-side core of the port: a copy of ``repro.core.batch_policy``."""
