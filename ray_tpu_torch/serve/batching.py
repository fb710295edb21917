"""@serve.batch dynamic batching (the port's copy of
``ray_tpu/serve/batching.py``; reference: ``serve/batching.py``).

Concurrent calls to a batched method inside one replica are collected into a
list and executed together; each caller gets its own element of the returned
list. The replica must run with ``max_concurrency > 1`` so calls can overlap
(the port's replicas default to 100, like the reference's async replicas).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int, wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.wait_timeout_s = wait_timeout_s
        self.lock = threading.Lock()
        self.items: List[Any] = []
        self.results: dict = {}
        self.done = threading.Condition(self.lock)
        self.leader_running = False

    def submit(self, instance, item) -> Any:
        my_id = object()
        with self.lock:
            self.items.append((my_id, item))
            am_leader = not self.leader_running
            if am_leader:
                self.leader_running = True
        if am_leader:
            # Drain batches until the queue is empty, then hand off leadership.
            while True:
                time.sleep(self.wait_timeout_s)  # let followers enqueue
                with self.lock:
                    batch = self.items[: self.max_batch_size]
                    self.items = self.items[self.max_batch_size:]
                if not batch:
                    with self.lock:
                        self.leader_running = False
                        self.done.notify_all()
                    break
                ids = [i for i, _ in batch]
                args = [a for _, a in batch]
                try:
                    outs = self.fn(instance, args)
                    if len(outs) != len(args):
                        raise ValueError(
                            f"@serve.batch function returned {len(outs)} "
                            f"results for {len(args)} inputs")
                except BaseException as e:  # noqa: BLE001
                    outs = [e] * len(args)
                with self.lock:
                    for i, out in zip(ids, outs):
                        self.results[i] = out
                    self.done.notify_all()
                    if not self.items:
                        self.leader_running = False
                        break
        with self.lock:
            deadline = time.monotonic() + 60.0
            while my_id not in self.results:
                if not self.leader_running and any(
                        i == my_id for i, _ in self.items):
                    # Leader exited between our enqueue and its drain: take over.
                    self.leader_running = True
                    self.lock.release()
                    try:
                        return self._lead_for_self(instance, my_id)
                    finally:
                        self.lock.acquire()
                self.done.wait(timeout=0.1)
                if time.monotonic() > deadline:
                    raise TimeoutError("batched call never executed")
            result = self.results.pop(my_id)
        if isinstance(result, BaseException):
            raise result
        return result

    def _lead_for_self(self, instance, my_id):
        while True:
            with self.lock:
                batch = self.items[: self.max_batch_size]
                self.items = self.items[self.max_batch_size:]
                if not batch:
                    self.leader_running = False
                    result = self.results.pop(my_id, None)
            if not batch:
                if isinstance(result, BaseException):
                    raise result
                return result
            ids = [i for i, _ in batch]
            args = [a for _, a in batch]
            try:
                outs = self.fn(instance, args)
            except BaseException as e:  # noqa: BLE001
                outs = [e] * len(args)
            with self.lock:
                for i, out in zip(ids, outs):
                    self.results[i] = out
                self.done.notify_all()
                if my_id in self.results and not self.items:
                    self.leader_running = False
                    result = self.results.pop(my_id)
                    if isinstance(result, BaseException):
                        raise result
                    return result


def batch(_fn: Callable = None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped method receives a LIST of inputs and must
    return a list of outputs of the same length."""

    def decorate(fn):
        queue_attr = f"__batch_queue_{fn.__name__}"
        params = (max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def wrapper(self, item):
            q = getattr(self, queue_attr, None)
            if q is None:
                q = _BatchQueue(fn, *params)
                setattr(self, queue_attr, q)
            return q.submit(self, item)

        wrapper.__is_serve_batched__ = True
        return wrapper

    if _fn is not None:
        return decorate(_fn)
    return decorate
