"""Fault-tolerant manager of a fleet of runner processes (the port of
``ray_tpu/rllib/actor_manager.py``).

Reference: ``rllib/utils/actor_manager.py:198``
(FaultTolerantActorManager): ``foreach`` over a fleet where a failed call
marks its member unhealthy, the fleet replaces it, and (optionally) the
call re-runs on the replacement, so an iteration keeps its full shard
count instead of silently shrinking.

The JAX package's fleet is actors; the port's is
:class:`~ray_tpu_torch.runtime.replica.ReplicaProcess` handles (a call is
``handle.call(method, args, kwargs)``, a future), and a replaced process
is killed and reaped.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

logger = logging.getLogger(__name__)


class FaultTolerantActorManager:
    """Owns a fleet of same-class processes made by ``factory(index)``,
    which returns a started
    :class:`~ray_tpu_torch.runtime.replica.ReplicaProcess`.

    ``foreach`` fans a method call across the fleet and gathers results;
    a member whose call fails is replaced via the factory, and with
    ``retry_on_replacement`` the call re-runs on the replacement (after
    ``on_replace`` re-initializes it, e.g. re-syncing weights) so the
    caller still receives one result per slot.
    """

    def __init__(self, factory: Callable[[int], Any], num_actors: int,
                 on_replace: Optional[Callable[[Any], None]] = None):
        self._factory = factory
        self._on_replace = on_replace
        self._next_index = num_actors
        self.actors: List[Any] = [factory(i) for i in range(num_actors)]
        self.num_replacements = 0

    def __len__(self) -> int:
        return len(self.actors)

    def _replace(self, slot: int):
        # Killed and reaped: a dropped handle would leak a process that
        # may still run.
        self.actors[slot].kill()
        self._next_index += 1
        self.num_replacements += 1
        actor = self._factory(self._next_index)
        self.actors[slot] = actor
        if self._on_replace is not None:
            try:
                self._on_replace(actor)
            except Exception:  # noqa: BLE001
                logger.exception("on_replace failed for slot %d", slot)
        return actor

    def foreach(self, method: str, *args, timeout_s: float = 300.0,
                retry_on_replacement: bool = True,
                **kwargs) -> List[Tuple[int, Any]]:
        """Call ``method(*args, **kwargs)`` on every member concurrently.

        Returns ``[(slot, result), ...]`` for every slot that produced a
        result. A failed call replaces the member; with retry the call
        re-runs ONCE on the replacement (a second failure drops the slot
        from this round: deterministic failures must not loop forever).
        """
        futures = [(slot, a.call(method, args, kwargs))
                   for slot, a in enumerate(self.actors)]
        results: List[Tuple[int, Any]] = []
        retry: List[int] = []
        for slot, fut in futures:
            try:
                results.append((slot, fut.result(timeout=timeout_s)))
            except Exception as e:  # noqa: BLE001
                logger.warning("actor slot %d failed %s: %s; replacing",
                               slot, method, e)
                self._replace(slot)
                if retry_on_replacement:
                    retry.append(slot)
        for slot in retry:
            try:
                fut = self.actors[slot].call(method, args, kwargs)
                results.append((slot, fut.result(timeout=timeout_s)))
            except Exception as e:  # noqa: BLE001
                logger.warning("replacement for slot %d also failed %s: %s",
                               slot, method, e)
                self._replace(slot)
        results.sort(key=lambda t: t[0])
        return results

    def healthy_count(self, timeout_s: float = 10.0) -> int:
        """Count responsive members. A ping TIMEOUT counts as healthy but
        busy (a member runs one call at a time: a ping queues behind a
        long sample(), and replacing a busy member would discard its
        work); only a dead member is replaced."""
        alive = 0
        probes = [(slot, a.call("ping", (), {})) for slot, a in
                  enumerate(self.actors)]
        for slot, fut in probes:
            try:
                fut.result(timeout=timeout_s)
                alive += 1
            except TimeoutError:
                alive += 1  # busy, not dead
            except Exception:  # noqa: BLE001
                self._replace(slot)
        return alive

    def kill_all(self) -> None:
        """Kill every member and wait for each."""
        for a in self.actors:
            a.kill()


__all__ = ["FaultTolerantActorManager"]
