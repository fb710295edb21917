"""The port's experimental surfaces (the counterpart of
``ray_tpu/experimental``): the shared-memory
:class:`~ray_tpu_torch.experimental.channel.Channel`."""

from ray_tpu_torch.experimental.channel import (Channel, ChannelClosed,
                                                ChannelTimeout)

__all__ = ["Channel", "ChannelClosed", "ChannelTimeout"]
