"""The port's process-level plumbing (the counterpart of
``ray_tpu/_private``): :mod:`~ray_tpu_torch._private.chaos`, the flight
recorder :mod:`~ray_tpu_torch._private.events` and the metric catalog
:mod:`~ray_tpu_torch._private.metrics_defs`."""
