"""The in-process runtime behind :func:`ray_tpu_torch.init` (the counterpart
of ``ray_tpu/_private/runtime``; the port's replica processes are
:mod:`ray_tpu_torch.runtime`)."""
