"""The port's experimental surfaces (the counterpart of
``ray_tpu/experimental``): the shared-memory
:class:`~ray_tpu_torch.experimental.channel.Channel` and the compiled-DAG
loop that runs over it."""

from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelTimeout, run_dag_loop)

__all__ = ["Channel", "ChannelClosed", "ChannelTimeout", "run_dag_loop"]
