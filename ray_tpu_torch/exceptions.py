"""The port's exception types (copies of ``ray_tpu/exceptions.py``'s:
the core API's, raised at ``get`` by the in-process runtime, and those of
the serve, train and RL planes).

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


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a not-yet-ported feature raises, naming its ROADMAP.md
    queue A item."""
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue A, {item}")


class RayTpuError(Exception):
    """Base class for all framework errors."""

    def __reduce__(self):
        return _rebuild, (type(self), self.args, dict(self.__dict__))


class RayTaskError(RayTpuError):
    """Wraps an exception raised inside a remote task, an actor method or
    a train loop's worker process. The in-process runtime stores it as
    the task's return object and re-raises it at ``get`` as an instance
    of the cause's class (:meth:`as_instanceof_cause`); a train worker
    wraps every error of the user's code that is not a framework error,
    so the controller charges it to ``FailureConfig.max_failures``. The
    remote traceback rides along. ``cause`` is the original exception
    (dropped when it is pickled and the cause does not pickle)."""

    def __init__(self, function_name: str = "", traceback_str: str = "",
                 cause: Optional[BaseException] = None, task_id=None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        self.task_id = task_id
        super().__init__(function_name, traceback_str)

    @classmethod
    def from_exception(cls, exc: BaseException, function_name: str,
                       task_id=None) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        return cls(function_name=function_name, traceback_str=tb, cause=exc,
                   task_id=task_id)

    def as_instanceof_cause(self) -> BaseException:
        """An exception that is an instance of the cause's class too, so
        ``except ValueError`` at the caller catches a remote ValueError."""
        cause = self.cause
        if cause is None:
            return self
        if isinstance(cause, RayTaskError):
            return cause.as_instanceof_cause()
        cause_cls = type(cause)
        if issubclass(cause_cls, RayTpuError):
            return cause
        try:

            class _cls(RayTaskError, cause_cls):  # type: ignore[misc]
                def __init__(self, inner: RayTaskError):
                    self._inner = inner

                def __getattr__(self, name):
                    return getattr(self._inner, name)

                def __str__(self):
                    return str(self._inner)

            _cls.__name__ = f"RayTaskError({cause_cls.__name__})"
            _cls.__qualname__ = _cls.__name__
            return _cls(self)
        except TypeError:
            return self

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


class TaskCancelledError(RayTpuError):
    """The task was cancelled before or during execution."""

    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(task_id)


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get`` did not complete within the requested timeout."""


class ActorDiedError(RayTaskError):
    """The actor died before or while executing the task: an in-process
    actor killed, exited or failed in ``__init__``, or a serve replica's
    or train worker's process that died (JAX's class, and its signature:
    pass ``error_msg`` by keyword)."""

    def __init__(self, actor_id=None,
                 error_msg: str = "The actor died unexpectedly."):
        self.actor_id = actor_id
        self.error_msg = error_msg
        self.function_name = ""
        self.traceback_str = error_msg
        self.cause = None
        self.task_id = None
        RayTpuError.__init__(self, error_msg)

    def __str__(self):
        return self.error_msg


# The reference's public name.
RayActorError = ActorDiedError


class ObjectLostError(RayTpuError):
    """The object's value was lost and could not be reconstructed."""

    def __init__(self, object_ref=None, message: str = ""):
        self.object_ref = object_ref
        super().__init__(message or f"Object {object_ref} was lost.")


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction for a lost object failed."""


class OwnerDiedError(ObjectLostError):
    """The worker that owned this object died, taking its metadata with
    it."""


class ObjectStoreFullError(RayTpuError):
    """The object store is out of memory."""


class OutOfMemoryError(RayTpuError):
    """A worker was killed by the memory monitor to avoid host OOM."""


class RuntimeEnvSetupError(RayTpuError):
    """Creating the runtime environment for a task or actor failed."""


class RaySystemError(RayTpuError):
    """Internal framework failure (deserialization, protocol, ...)."""


class PendingCallsLimitExceeded(RayTpuError):
    """An actor's pending call queue exceeded ``max_pending_calls``."""


class AsyncioActorExit(RayTpuError):
    """Internal: ``exit_actor()`` ends the actor after the current
    call."""


class CheckpointCorruptError(RayTpuError):
    """A committed checkpoint's shard data failed integrity verification
    (crc32 mismatch against the spec, unreadable/truncated shard file).
    ``CheckpointPlane.restore``/``load_latest`` fall back to the previous
    committed manifest instead of surfacing this."""


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
