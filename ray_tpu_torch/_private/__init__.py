"""The port's process-level plumbing (the counterpart of
``ray_tpu/_private``): :mod:`~ray_tpu_torch._private.chaos`."""
