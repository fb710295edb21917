"""Observability utilities (the counterpart of ``ray_tpu/util``):
:mod:`~ray_tpu_torch.util.metrics` and :mod:`~ray_tpu_torch.util.tracing`."""
