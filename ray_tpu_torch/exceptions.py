"""The port's exception types (copies of ``ray_tpu/exceptions.py``'s, for
the paths the port has)."""


class RayTpuError(Exception):
    """Base class for all framework errors."""


class CheckpointCorruptError(RayTpuError):
    """A committed checkpoint's shard data failed integrity verification
    (crc32 mismatch against the spec, unreadable/truncated shard file).
    ``CheckpointPlane.restore``/``load_latest`` fall back to the previous
    committed manifest instead of surfacing this."""
