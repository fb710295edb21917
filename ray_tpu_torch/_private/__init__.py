"""The port's process-level plumbing (the counterpart of
``ray_tpu/_private``): the core API's in-process runtime
(:mod:`~ray_tpu_torch._private.worker`,
:mod:`~ray_tpu_torch._private.runtime.local` and the ids, options, object
refs and store under it), :mod:`~ray_tpu_torch._private.chaos`, the
flight recorder :mod:`~ray_tpu_torch._private.events`, the metric catalog
:mod:`~ray_tpu_torch._private.metrics_defs` and the profiling plane
:mod:`~ray_tpu_torch._private.cuda_monitor`."""
