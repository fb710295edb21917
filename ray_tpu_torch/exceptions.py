"""The port's exception types (copies of ``ray_tpu/exceptions.py``'s, for
the paths the port has)."""


class RayTpuError(Exception):
    """Base class for all framework errors."""


class CheckpointCorruptError(RayTpuError):
    """A committed checkpoint's shard data failed integrity verification
    (crc32 mismatch against the spec, unreadable/truncated shard file).
    ``CheckpointPlane.restore``/``load_latest`` fall back to the previous
    committed manifest instead of surfacing this."""


class ActorDiedError(RayTpuError):
    """The replica process died before or while serving the request (the
    port's replicas are spawned processes, not actors; the JAX package's
    name is kept so the recovery code reads the same)."""

    def __init__(self, error_msg: str = "The actor died unexpectedly."):
        self.error_msg = error_msg
        super().__init__(error_msg)


class ReplicaDrainingError(RayTpuError):
    """The serve replica is draining (controller-initiated: scale-down,
    preemption, rolling update) and no longer admits new requests. A
    clean reject — the replica did no work — so routers retry on another
    replica without consuming the request's resume budget."""

    def __init__(self, reason: str = "replica is draining"):
        self.reason = reason
        super().__init__(reason)


class ResumeExhaustedError(RayTpuError):
    """A serve request's per-request resume budget
    (``RAY_TPU_SERVE_MAX_RESUMES``) ran out: the request was resubmitted/
    resumed after replica death the maximum number of times and the last
    attempt also failed. Terminal — the caller sees this instead of the
    raw ``ActorDiedError`` so it can distinguish "the fabric tried and
    gave up" from "a replica died"."""

    def __init__(self, reason: str = "resume budget exhausted",
                 resumes: int = 0):
        self.resumes = resumes
        super().__init__(f"{reason} (after {resumes} resume(s))")
