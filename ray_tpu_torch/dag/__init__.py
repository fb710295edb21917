"""ray_tpu_torch.dag: lazy task/actor DAGs + compiled execution (the port's
copy of ``ray_tpu/dag``).

Reference: ``python/ray/dag`` (aDAG) — ``.bind()`` builds a lazy graph,
``.execute()`` submits it, and ``experimental_compile`` turns a static
graph into a reusable executable whose channels avoid per-call
(re)submission overhead. Compiled, each actor of the graph runs
:func:`~ray_tpu_torch.experimental.channel.run_dag_loop` on one of its
threads and a hop costs a write and a read of a shared-memory
:class:`~ray_tpu_torch.experimental.channel.Channel` (one per edge,
``/dev/shm/rtch-*``, the layout JAX's channel reads). ``teardown`` closes
and unlinks every one of them, also after a stage error and with results
never read.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import ray_tpu_torch


class DAGNode:
    """Base lazy node. ``execute`` submits the whole upstream graph."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- graph plumbing ----------------------------------------------------
    def _resolve_arg(self, arg, cache: Dict[int, Any]):
        if isinstance(arg, DAGNode):
            return arg._execute_cached(cache)
        return arg

    def _resolved(self, cache: Dict[int, Any]):
        args = tuple(self._resolve_arg(a, cache) for a in self._bound_args)
        kwargs = {k: self._resolve_arg(v, cache)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_cached(self, cache: Dict[int, Any]):
        key = id(self)
        if key not in cache:
            cache[key] = self._execute_impl(cache)
        return cache[key]

    def _execute_impl(self, cache: Dict[int, Any]):
        raise NotImplementedError

    def execute(self, *input_args, **input_kwargs):
        cache: Dict[int, Any] = {
            id(n): v for n, v in zip(_collect_input_nodes(self), input_args)}
        return self._execute_cached(cache)

    def experimental_compile(self, _buffer_size_bytes: Optional[int] = None) \
            -> "CompiledDAG":
        return CompiledDAG(self, buffer_size_bytes=_buffer_size_bytes)


class InputNode(DAGNode):
    """Placeholder for per-execution input (reference: ``ray.dag.InputNode``)."""

    _tls = threading.local()

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_impl(self, cache):
        raise ValueError("InputNode value missing: pass it to execute(...)")


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, cache):
        args, kwargs = self._resolved(cache)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """Lazy actor construction; methods of the (future) actor can be bound."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None
        self._lock = threading.Lock()

    def _ensure_actor(self, cache):
        with self._lock:
            if self._handle is None:
                args, kwargs = self._resolved(cache)
                self._handle = self._actor_cls.remote(*args, **kwargs)
        return self._handle

    def _execute_impl(self, cache):
        return self._ensure_actor(cache)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClassMethodBinder(self, name)


class _ClassMethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ActorMethodNode":
        return ActorMethodNode(self._class_node, self._method, args, kwargs)


class ActorMethodNode(DAGNode):
    def __init__(self, target, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._target = target  # ActorHandle or ClassNode
        self._method_name = method_name

    def _execute_impl(self, cache):
        args, kwargs = self._resolved(cache)
        target = self._target
        if isinstance(target, ClassNode):
            target = target._ensure_actor(cache)
        return getattr(target, self._method_name).remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    def __init__(self, nodes: List[DAGNode]):
        super().__init__(tuple(nodes), {})

    def _execute_impl(self, cache):
        return [self._resolve_arg(n, cache) for n in self._bound_args]


def _collect_input_nodes(root: DAGNode) -> List[InputNode]:
    seen: List[InputNode] = []
    visited = set()

    def visit(node):
        if id(node) in visited:
            return
        visited.add(id(node))
        if isinstance(node, InputNode) and node not in seen:
            seen.append(node)
        for a in list(node._bound_args) + list(node._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                visit(a)

    visit(root)
    return seen


class _UnsupportedDAG(Exception):
    """Graph shape the channel compiler can't pin; interpreted fallback."""


class CompiledDAGRef:
    """Result handle of one compiled execution (reference:
    ``CompiledDAGRef``): ``get()`` blocks on the DAG's output channel."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None):
        return self._dag._get_result(self._seq, timeout)


class CompiledDAG:
    """Reusable executable of a static DAG (reference:
    ``dag/compiled_dag_node.py:767``).

    Compilation pins the DAG onto mutable shared-memory channels
    (``experimental/channel.py``): every actor runs a ``__ray_dag_loop__``
    schedule reading inputs and writing outputs in place, so a per-step hop
    costs a channel write/read (microseconds) instead of a lease + RPC +
    pickle round-trip. ``execute`` writes the input channel and returns a
    ``CompiledDAGRef``; results stream out in submission order.

    Graphs that don't fit the channel model (plain function nodes, no
    InputNode) fall back to interpreted per-call submission.
    """

    def __init__(self, root: DAGNode, buffer_size_bytes: Optional[int] = None):
        from ray_tpu_torch.experimental import channel as chan

        self._root = root
        self._chan = chan
        self._capacity = buffer_size_bytes or chan.DEFAULT_CAPACITY
        # Materialize all ClassNodes now (actor startup off the hot path).
        warm: Dict[int, Any] = {}
        for node in _walk(root):
            if isinstance(node, ClassNode):
                node._ensure_actor(warm)
        self._warm = warm
        self._lock = threading.RLock()
        self._next_seq = 0
        self._read_count = 0
        self._partial: List[Any] = []
        self._results: Dict[int, Any] = {}
        self._torn_down = False
        try:
            self._build_channels()
            self._channel_mode = True
        except _UnsupportedDAG:
            self._channel_mode = False

    # ------------------------------------------------------------- compile
    def _topo_nodes(self) -> List[DAGNode]:
        order: List[DAGNode] = []
        seen = set()

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen.add(id(node))
            deps = [a for a in list(node._bound_args)
                    + list(node._bound_kwargs.values())
                    if isinstance(a, DAGNode)]
            for d in deps:
                visit(d)
            order.append(node)

        visit(self._root)
        return order

    def _build_channels(self):
        chan = self._chan
        topo = self._topo_nodes()
        inputs = [n for n in topo if isinstance(n, InputNode)]
        outputs = (list(self._root._bound_args)
                   if isinstance(self._root, MultiOutputNode)
                   else [self._root])
        compute = [n for n in topo
                   if not isinstance(n, (InputNode, MultiOutputNode,
                                         ClassNode))]
        if len(inputs) != 1 or not compute:
            raise _UnsupportedDAG("channel mode needs one InputNode")
        if not all(isinstance(n, ActorMethodNode) for n in compute):
            raise _UnsupportedDAG("channel mode pins actor methods only")
        if not all(isinstance(o, ActorMethodNode) for o in outputs):
            raise _UnsupportedDAG("outputs must be actor methods")

        # Count consumer edges per producer (driver counts for outputs).
        n_edges: Dict[int, int] = {}
        for n in compute:
            for a in list(n._bound_args) + list(n._bound_kwargs.values()):
                if isinstance(a, DAGNode):
                    n_edges[id(a)] = n_edges.get(id(a), 0) + 1
        for o in outputs:
            n_edges[id(o)] = n_edges.get(id(o), 0) + 1

        self._channels: List[Any] = []
        out_chan: Dict[int, Any] = {}
        for n in [inputs[0]] + compute:
            if id(n) not in n_edges:
                raise _UnsupportedDAG(f"dangling node {n}")
            c = chan.Channel(capacity=self._capacity,
                             n_readers=n_edges[id(n)])
            out_chan[id(n)] = c
            self._channels.append(c)

        next_idx: Dict[int, int] = {}

        def reader_for(producer: DAGNode):
            i = next_idx.get(id(producer), 0)
            next_idx[id(producer)] = i + 1
            return out_chan[id(producer)].reader(i)

        # Per-actor executable schedule in topological order (reference:
        # ExecutableTask lists, compiled_dag_node.py:161).
        def handle_of(node: ActorMethodNode):
            target = node._target
            if isinstance(target, ClassNode):
                target = target._ensure_actor(self._warm)
            return target

        per_actor: Dict[bytes, List[tuple]] = {}
        actor_handles: Dict[bytes, Any] = {}
        for n in compute:
            h = handle_of(n)
            key = h._actor_id.binary()
            arg_slots = [reader_for(a) if isinstance(a, DAGNode) else a
                         for a in n._bound_args]
            kwarg_slots = {k: (reader_for(v) if isinstance(v, DAGNode)
                               else v)
                           for k, v in n._bound_kwargs.items()}
            per_actor.setdefault(key, []).append(
                (n._method_name, arg_slots, kwarg_slots, out_chan[id(n)]))
            actor_handles[key] = h

        # Driver endpoints (readers assigned after actor edges).
        self._input_channel = out_chan[id(inputs[0])]
        self._output_readers = [reader_for(o) for o in outputs]
        self._multi_output = isinstance(self._root, MultiOutputNode)
        # Bound in-flight executions to the pipeline's holding capacity so
        # an over-eager submit blocks HERE (lock-free) instead of inside the
        # input-channel write while holding the driver lock — which would
        # deadlock, since draining results also needs that lock (reference:
        # max in-flight executions, compiled_dag_node.py). Capacity along a
        # path of d actors is d+1 channel slots + d in-execution slots; the
        # shallowest input→output path is the bottleneck.
        depth: Dict[int, int] = {id(inputs[0]): 0}
        for n in compute:  # topo order: producers already have depths
            dag_args = [a for a in list(n._bound_args)
                        + list(n._bound_kwargs.values())
                        if isinstance(a, DAGNode)]
            n_depth = 1 + min(depth.get(id(a), 0) for a in dag_args)
            depth[id(n)] = n_depth
        min_depth = min(depth.get(id(o), 1) for o in outputs)
        self._inflight_sem = threading.Semaphore(2 * min_depth + 1)

        from ray_tpu_torch.actor import ActorMethod

        self._loop_refs = [
            ActorMethod(actor_handles[key], "__ray_dag_loop__").remote(ops)
            for key, ops in per_actor.items()]

    # ------------------------------------------------------------- execute
    def execute(self, *input_args):
        if self._torn_down:
            raise RuntimeError("CompiledDAG was torn down")
        if not self._channel_mode:
            return self._root.execute(*input_args)
        value = input_args[0] if len(input_args) == 1 else input_args
        # Block lock-free while the pipeline is full; a single-threaded
        # caller that never drains would wait forever, so surface the
        # misuse after a bounded wait (reference raises when max buffered
        # results is exceeded).
        if not self._inflight_sem.acquire(timeout=60.0):
            raise RuntimeError(
                "compiled DAG pipeline is full and no result was consumed "
                "for 60s; call get() on earlier CompiledDAGRefs to drain")
        try:
            with self._lock:
                # Write under the lock: the channel is single-writer, and
                # the seq must match the write order. The semaphore
                # guarantees a free slot, so this write cannot block.
                self._input_channel.write(value)
                seq = self._next_seq
                self._next_seq += 1
        except BaseException:
            self._inflight_sem.release()
            raise
        return CompiledDAGRef(self, seq)

    def _get_result(self, seq: int, timeout: Optional[float]):
        chan = self._chan
        with self._lock:
            if seq < self._read_count and seq not in self._results:
                raise ValueError(
                    f"CompiledDAGRef (execution #{seq}) was already "
                    f"consumed; get() may only be called once per ref")
            while seq >= self._read_count:
                # Resume partially-read ticks: a timeout mid-tick must not
                # discard values already consumed from earlier readers or
                # every later result would pair mismatched executions.
                while len(self._partial) < len(self._output_readers):
                    r = self._output_readers[len(self._partial)]
                    self._partial.append(r.read(timeout=timeout))
                vals, self._partial = self._partial, []
                self._results[self._read_count] = (
                    vals if self._multi_output else vals[0])
                self._read_count += 1
                self._inflight_sem.release()
            out = self._results.pop(seq)
        for v in (out if isinstance(out, list) else [out]):
            if isinstance(v, chan._StageError):
                raise v.exc
        return out

    def teardown(self):
        if self._torn_down:
            return
        self._torn_down = True
        if self._channel_mode:
            # Close EVERY channel, not just the input: an actor blocked
            # writing an unread output would never observe an input-only
            # close and would spin forever in the pinned loop.
            for c in self._channels:
                c.close()
            for ref in self._loop_refs:
                try:
                    ray_tpu_torch.get(ref, timeout=10)
                except Exception:  # noqa: BLE001
                    pass
            for c in self._channels:
                c.destroy()
        for node in _walk(self._root):
            if isinstance(node, ClassNode) and node._handle is not None:
                try:
                    ray_tpu_torch.kill(node._handle)
                except Exception:  # noqa: BLE001
                    pass


def _walk(root: DAGNode):
    visited = set()
    stack = [root]
    while stack:
        node = stack.pop()
        if id(node) in visited:
            continue
        visited.add(id(node))
        yield node
        for a in list(node._bound_args) + list(node._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                stack.append(a)
        if isinstance(node, ActorMethodNode) and \
                isinstance(node._target, ClassNode):
            stack.append(node._target)


__all__ = [
    "ActorMethodNode", "ClassNode", "CompiledDAG", "CompiledDAGRef",
    "DAGNode", "FunctionNode", "InputNode", "MultiOutputNode",
]
