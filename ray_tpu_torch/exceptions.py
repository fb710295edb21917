"""The port's exception types (copies of ``ray_tpu/exceptions.py``'s, for
the paths the port has).

They cross process boundaries (a train worker's or a serve replica's
error reaches the controller over a pipe), so each pickles with its
fields: :meth:`RayTpuError.__reduce__` rebuilds the instance from its
``args`` and ``__dict__`` without calling ``__init__`` again."""

import traceback
from typing import Optional


def _rebuild(cls, args, state):
    err = cls.__new__(cls)
    err.args = args
    err.__dict__.update(state)
    return err


class RayTpuError(Exception):
    """Base class for all framework errors."""

    def __reduce__(self):
        return _rebuild, (type(self), self.args, dict(self.__dict__))


class RayTaskError(RayTpuError):
    """A train loop raised inside its worker process (the JAX package's
    name for an exception raised inside a remote task). The worker wraps
    every error of the user's code that is not a framework error, so the
    controller charges it to ``FailureConfig.max_failures``; the remote
    traceback rides along. ``cause`` is the original exception when it
    pickles, else None."""

    def __init__(self, function_name: str = "", traceback_str: str = "",
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(function_name, traceback_str)

    @classmethod
    def from_exception(cls, exc: BaseException,
                       function_name: str) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        return cls(function_name=function_name, traceback_str=tb, cause=exc)

    def __reduce__(self):
        import pickle

        state = dict(self.__dict__)
        try:
            pickle.dumps(self.cause)
        except Exception:  # noqa: BLE001 — any pickling failure: drop it
            state["cause"] = None
        return _rebuild, (type(self), self.args, state)

    def __str__(self):
        return (f"{type(self).__name__}: task {self.function_name!r} "
                f"failed\n{self.traceback_str}")


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


class ActorUnavailableError(RayTpuError):
    """The worker process is temporarily unreachable (e.g. restarting)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class PreemptedError(RayTpuError):
    """A training worker stopped because its host is being preempted
    (SIGTERM / maintenance event). Raised by train loops after their
    just-in-time checkpoint; the trainer controller treats it as
    retryable and resumes from the newest committed manifest."""

    def __init__(self, reason: str = "host preempted", notice=None):
        self.reason = reason
        self.notice = notice
        super().__init__(reason)


class NodeDiedError(RayTpuError):
    """The node running the worker died."""


class WorkerHangError(RayTpuError):
    """A training worker stopped making progress while staying reachable:
    either its per-step watchdog lapsed (hung collective / wedged step)
    or its heartbeats stopped arriving. Retryable — the elastic trainer
    tears the group down and re-forms it (restart budget, not
    ``max_failures``)."""

    def __init__(self, reason: str = "worker hang detected",
                 rank=None, kind: str = "watchdog"):
        self.reason = reason
        self.rank = rank
        self.kind = kind  # "watchdog" | "heartbeat"
        super().__init__(reason)


class WorkerStoppedError(RayTpuError):
    """Cooperative stop: the controller is tearing this worker group down
    (elastic restart/resize) and the session's stop flag is set. Raised
    out of ``train.report()`` and the checkpoint plane's save so a loop
    that outlives its teardown unwinds instead of racing the next
    attempt's checkpoint writes."""


class NaNLossError(RayTpuError):
    """The training loss was non-finite for too many consecutive reports.
    Classified FATAL: restarting from the same checkpoint would replay
    the same divergence, so no retry budget is consumed."""

    def __init__(self, reason: str = "non-finite training loss",
                 reports: int = 0):
        self.reports = reports
        super().__init__(f"{reason} ({reports} consecutive reports)")


class DistributedBootstrapError(RayTpuError):
    """Forming the workers' ``torch.distributed`` process group failed
    after rendezvous port-rebind retries (the JAX package's
    ``JaxDistributedBootstrapError``) — the environment cannot run the
    group (fatal, not retryable)."""
