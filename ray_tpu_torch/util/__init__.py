"""Utilities (the counterpart of ``ray_tpu/util``):
:mod:`~ray_tpu_torch.util.metrics`, :mod:`~ray_tpu_torch.util.tracing`
and the host-tier :mod:`~ray_tpu_torch.util.collective`."""
