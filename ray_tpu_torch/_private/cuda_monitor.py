"""Per-process device observability: the compile/retrace/cost/capture
plane (the port of ``ray_tpu/_private/xla_monitor.py``).

* :func:`instrument` wraps a framework-owned entry point (the engine's
  prefill, tick, spec tick, draft prefill and scoring; the generator's
  prefill and decode; the trainer's init and step). PyTorch runs eagerly
  and has no jit, so a *compile* is the first call at a new argument
  signature: its wall time (the kernels' first build included) is the
  compile time. The signature rule and the **retrace detector** are
  JAX's (``_leaf_sig``, ``_changed_dims``, ``shape_policy``), so the
  same sequence of shapes gives the same compile and retrace counts.
* the first call at each signature runs under a dispatch mode that
  counts each aten op's FLOPs by
  :class:`torch.utils.flop_counter.FlopCounterMode`'s formulas and its
  input and output bytes: the program's cost, of what
  runs (remat replays included), as XLA's ``cost_analysis`` prices what
  it compiled. The hand kernels are ``ctypes`` calls the counters cannot
  see, so each kernel wrapper adds its own analytic FLOPs and bytes
  (:func:`add_kernel_cost`) while a count is active. A program on the
  request path (the engine's and the generator's) passes an analytic
  ``cost`` instead: its first call at a signature runs as every later
  one does, with no count and no device sync, and the signature's cost
  is the formula's (the count runs every aten op through Python, and a
  burst of a new prefill bucket would wait on it). Call sites that
  measure a step's wall time feed it back through
  :meth:`InstrumentedProgram.note_execution`, which sets the achieved
  FLOP/s, bytes/s and MFU gauges; absent a measurement the wrapper
  falls back to call cadence.
* :func:`sample_device_memory` publishes ``torch.cuda.memory_stats`` and
  ``mem_get_info`` per card as gauges (``[]`` on a process that holds no
  card: it never initializes CUDA itself).
* the capture plane: :func:`capture` runs a ``torch.profiler`` capture
  in this process for a while and writes a Chrome trace under the
  session dir. The serving process sends the command to replica
  processes over their control pipes (:func:`request_capture`) and keeps
  the records (:func:`list_captures`); :func:`list_programs` gathers the
  program registry of this process and of each live replica. There is no
  GCS: the records live in the serving process.

``RAY_TPU_XLA_MONITOR=0`` turns the wrapper into a plain call. The peak
table names the H100 only; another card reports achieved rates without
a utilization.
"""

from __future__ import annotations

import functools
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

logger = logging.getLogger(__name__)

# Dense bf16 tensor-core FLOP/s of one card by device name (prefix
# match): NVIDIA's data sheet for the H100 SXM, at its 700 W limit. MFU
# is only emitted when the name is known and the program ran on a card.
PEAK_FLOPS = {
    "NVIDIA H100": 989e12,
}


def _enabled() -> bool:
    return os.environ.get("RAY_TPU_XLA_MONITOR", "1") != "0"


def session_dir() -> str:
    """Where captures are written: ``RAY_TPU_SESSION_DIR``, else
    ``ray_tpu_state`` under the process's temp dir."""
    return os.environ.get("RAY_TPU_SESSION_DIR") or os.path.join(
        tempfile.gettempdir(), "ray_tpu_state")


_state_lock = threading.Lock()
_programs: Dict[str, "_ProgramRecord"] = {}
_capture_lock = threading.Lock()          # one profiler capture at a time
_captures: Dict[str, Dict[str, Any]] = {}  # key -> record (serving side)
_capture_seq = itertools.count()
# (program, signature, its non-array arguments) -> counted cost: a second
# wrapper of one program (another engine, trainer or learner in this
# process) at a signature already counted takes the count.
_costs: Dict[Any, Optional[Dict[str, float]]] = {}
# Calls already inside an instrumented program run through unobserved
# (JAX inlines a jit called under an outer trace).
_tls = threading.local()


# ----------------------------------------------------------- program registry
class _ProgramRecord:
    __slots__ = ("name", "compiles", "retraces", "signatures", "cost",
                 "compile_seconds")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.retraces = 0
        # signature key -> {"signature", "seconds", "flops", ...}
        self.signatures: Dict[Any, Dict[str, Any]] = {}
        self.cost: Optional[Dict[str, Any]] = None   # latest compile's
        self.compile_seconds = 0.0


def _record(name: str) -> _ProgramRecord:
    with _state_lock:
        rec = _programs.get(name)
        if rec is None:
            rec = _programs[name] = _ProgramRecord(name)
        return rec


def program_stats(name: str) -> Optional[Dict[str, Any]]:
    """Latest compile stats for a program: compiles, retraces, compile
    seconds, signatures, and the latest signature's counted cost."""
    rec = _programs.get(name)
    if rec is None:
        return None
    out = {"name": rec.name, "compiles": rec.compiles,
           "retraces": rec.retraces,
           "compile_seconds": rec.compile_seconds,
           "signatures": len(rec.signatures)}
    if rec.cost:
        out.update(rec.cost)
    return out


def all_program_stats() -> List[Dict[str, Any]]:
    return [s for s in (program_stats(n) for n in list(_programs))
            if s is not None]


# ------------------------------------------------------------- signatures
def _leaf_sig(x) -> Tuple:
    if isinstance(x, (bool, int, float, complex)):
        # Python scalars are keyed by TYPE, never by value, or a decode
        # loop's position arg would count a compile per token.
        return (type(x).__name__, "weak")
    shape, dtype = getattr(x, "shape", None), getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype), False)
    return ("opaque", type(x).__name__)


def _flatten(x, leaves: List[Any]):
    """The tree's structure (dicts by SORTED key, as JAX's treedef keys
    them, so two dicts of one content in another insertion order are one
    signature; lists, tuples and named tuples by position); its leaves
    are appended to ``leaves``."""
    if isinstance(x, dict):
        keys = sorted(x, key=str)
        return ("dict", tuple(keys),
                tuple(_flatten(x[k], leaves) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return None


def _fmt_sig(leaf_sigs: Sequence[Tuple]) -> str:
    parts = []
    for s in leaf_sigs:
        if isinstance(s[0], tuple):
            parts.append(f"{s[1]}[{','.join(map(str, s[0]))}]"
                         + ("w" if s[2] else ""))
        else:
            parts.append(f"{s[0]}:{s[1]}")
    return "(" + ", ".join(parts) + ")"


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _changed_dims(old: Sequence[Tuple], new: Sequence[Tuple]) -> \
        Optional[List[int]]:
    """Dims (new values) that differ between two same-structure leaf-sig
    tuples; None when the signatures differ beyond shapes (dtype/type)."""
    if len(old) != len(new):
        return None
    dims: List[int] = []
    for o, n in zip(old, new):
        if o == n:
            continue
        if not (isinstance(o[0], tuple) and isinstance(n[0], tuple)) \
                or o[1:] != n[1:] or len(o[0]) != len(n[0]):
            return None                  # dtype / structure change
        dims.extend(nd for od, nd in zip(o[0], n[0]) if od != nd)
    return dims


# ------------------------------------------------------------------- cost
def _moves_data(func) -> bool:
    """False for ops that move no bytes: views (a return aliasing an
    input without writing it) and allocations."""
    name = func.__name__
    if name.startswith(("empty", "_local_scalar_dense")):
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


def _nbytes(x) -> int:
    """Bytes of the tensors in an op's argument or result (tensors, and
    lists or tuples of them, as aten ops take and return)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _CostMode(TorchDispatchMode):
    """Counts every aten op's FLOPs by the formulas of
    :class:`torch.utils.flop_counter.FlopCounterMode` (its
    ``flop_registry``: mm, bmm, addmm, convolutions, attention) and the
    bytes it reads and writes (its tensor inputs and outputs, each once),
    plus the analytic FLOPs and bytes the hand kernels report through
    :func:`add_kernel_cost`. ``FlopCounterMode`` itself is not entered: it
    runs a composite op it has no formula for through
    ``func.decompose()``, which changed the bits of a train step's grads
    (``tests/test_torch_cuda_monitor.py``); this mode runs every op as
    it is, so a counted call computes what an uncounted one does. The
    dispatch mode stack travels with autograd's worker threads, so a
    kernel launched in a backward finds this count too."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        # Per op: (its FLOP formula or None, whether it moves bytes).
        self._ops: Dict[Any, Tuple[Any, bool]] = {}
        self.flops = 0
        self.bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = (
                self._formulas.get(func._overloadpacket), _moves_data(func))
        formula, moves = op
        flops = 0
        if formula is not None:
            try:
                flops = formula(*args, **kwargs, out_val=out)
            except Exception:  # noqa: BLE001 - counting never fails a call
                logger.debug("no FLOP count for %s", func, exc_info=True)
        n = 0
        if moves:
            n = (_nbytes(args) + _nbytes(tuple(kwargs.values()))
                 + _nbytes(out))
        with self._lock:
            self.flops += flops
            self.bytes += n
        return out

    def add_kernel(self, flops: float, nbytes: float) -> None:
        with self._lock:
            self.kernel_flops += flops
            self.kernel_bytes += nbytes


def _active_cost_modes() -> List[_CostMode]:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, _CostMode)]


def cost_active() -> bool:
    """True while an instrumented program's cost is being counted on
    this thread (a kernel wrapper then reports its analytic cost)."""
    return bool(_active_cost_modes())


def add_kernel_cost(flops: float, nbytes: float) -> None:
    """A hand kernel's FLOPs and bytes (each input read once, each output
    written once) into the active count; nothing without one."""
    for mode in _active_cost_modes():
        mode.add_kernel(flops, nbytes)


def flash_cost(which: str, b: int, hq: int, hkv: int, sq: int, sk: int,
               d: int, causal: bool, item: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash kernel (``"fwd"``, ``"dq"``,
    ``"dkv"``): 4 D operations a live (query, key) pair forward, 6 D for
    dq, 8 D for dk/dv; q, k, v (and dO, out, lse, delta) read once and
    the outputs written once. Causal is bottom-right aligned."""
    if causal:
        offs = sk - sq
        per_head = sum(min(sk, max(0, r + offs + 1)) for r in range(sq)) \
            if offs < 0 else sq * (offs + 1) + sq * (sq - 1) // 2
    else:
        per_head = sq * sk
    pairs = b * hq * per_head
    q = b * sq * hq * d * item
    kv = b * sk * hkv * d * item
    row = b * hq * sq * 4
    return {"fwd": (4 * d * pairs, q + 2 * kv + q + row),
            "dq": (6 * d * pairs, 2 * q + 2 * kv + 2 * row + q),
            "dkv": (8 * d * pairs, 2 * q + 2 * kv + 2 * row + 2 * kv)}[
                which]


def decode_cost(live_tokens: int, slots: int, hq: int, hkv: int, d: int,
                kv_item: int, q_item: int, table_entries: int = 0,
                scales: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode-attention call: 4 Hq D operations a
    live token; the live K/V rows (and int8 scales), table entries,
    positions, q and out each moved once."""
    nbytes = live_tokens * hkv * d * kv_item * 2
    if scales:
        nbytes += live_tokens * hkv * 4 * 2
    nbytes += table_entries * 4 + slots * 4 + 2 * slots * hq * d * q_item
    return live_tokens * 4 * hq * d, nbytes


def _count_cost(fn, args, kwargs):
    """Run ``fn`` once under the counters: (its output, {"flops",
    "bytes_accessed"})."""
    cost_mode = _CostMode()
    with cost_mode:
        out = fn(*args, **kwargs)
    flops = float(cost_mode.flops + cost_mode.kernel_flops)
    nbytes = float(cost_mode.bytes + cost_mode.kernel_bytes)
    cost = {}
    if flops:
        cost["flops"] = flops
    if nbytes:
        cost["bytes_accessed"] = nbytes
    return out, cost or None


def _device_of(leaves) -> Optional[torch.device]:
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


# --------------------------------------------------------------- the wrapper
class InstrumentedProgram:
    """A callable with compile/retrace/cost observability.

    A compile is the first call at a new signature (the tree of the
    arguments, dicts by sorted key, and each leaf's shape and dtype;
    Python scalars by type). Its cost is counted once a process for each
    program, signature and set of flags and configs.
    That call runs under the cost counters; later calls at a known
    signature run ``fn`` as it is. Calls made inside another
    instrumented program's call run through unobserved.

    ``shape_policy``:

    * ``"static"`` - the program has ONE legitimate signature; any second
      compile is a retrace.
    * ``"bucketed"`` - new signatures are expected as long as every
      changed dim is a power of two (or listed in ``allowed_dims``).
    * ``"free"`` - compile tracking only.

    An error in the counted first call propagates and the signature stays
    unrecorded, so the next call counts again; no call runs ``fn`` twice
    (a program may update its inputs in place, as the trainer's step
    does). ``device``: where the program runs, when no tensor among its
    arguments says (a prefill handed host index arrays). ``cost``: a
    function of the call's arguments giving ``{"flops",
    "bytes_accessed"}`` by formula; with it no call is counted or synced,
    and a compile's seconds are its first call's dispatch.
    """

    def __init__(self, fn, name: str, shape_policy: str = "static",
                 allowed_dims: Sequence[int] = (), device=None, cost=None):
        assert shape_policy in ("static", "bucketed", "free"), shape_policy
        self.fn = fn
        self.name = name
        self.shape_policy = shape_policy
        self.allowed_dims = frozenset(int(d) for d in allowed_dims)
        self.device = torch.device(device) if device is not None else None
        self.cost = cost
        self._sigs: Dict[Any, List[Tuple]] = {}   # sig key -> leaf sigs
        self._last_key: Optional[Any] = None
        # Timing state is PER WRAPPER: two engines sharing a program name
        # must not garble each other's achieved gauges.
        self._last_call: Optional[float] = None
        self._external_timing = False
        self._lock = threading.Lock()
        functools.update_wrapper(self, fn, updated=())

    def _cache_size(self) -> int:
        """Signatures seen: the count of compiled programs."""
        return len(self._sigs)

    def __call__(self, *args, **kwargs):
        if not _enabled() or getattr(_tls, "depth", 0):
            return self.fn(*args, **kwargs)
        leaves: List[Any] = []
        structure = _flatten((args, kwargs), leaves)
        leaf_sigs = tuple(_leaf_sig(x) for x in leaves)
        key = (structure, leaf_sigs)
        self._note_cadence()
        self._last_key = key
        _tls.depth = 1
        try:
            if key in self._sigs:
                return self.fn(*args, **kwargs)
            return self._compile_and_call(key, leaf_sigs, leaves, args,
                                          kwargs)
        finally:
            _tls.depth = 0

    def _compile_and_call(self, key, leaf_sigs, leaves, args, kwargs):
        with self._lock:
            if key in self._sigs:        # lost the race
                return self.fn(*args, **kwargs)
            t0 = time.perf_counter()
            device = _device_of(leaves) or self.device
            if self.cost is not None:
                cost = self.cost(*args, **kwargs)
                out = self.fn(*args, **kwargs)
                self._observe_compile(key, leaf_sigs,
                                      time.perf_counter() - t0, cost,
                                      device)
                return out
            # Flags and configs count too: a kernel on or off is one
            # signature but another cost.
            counted = (self.name, key, str(device), tuple(
                repr(x) for x in leaves
                if isinstance(x, bool) or not isinstance(
                    x, (torch.Tensor, int, float, complex))
                and getattr(x, "shape", None) is None))
            if counted in _costs:
                out, cost = self.fn(*args, **kwargs), _costs[counted]
            else:
                out, cost = _count_cost(self.fn, args, kwargs)
                _costs[counted] = cost
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            self._observe_compile(key, leaf_sigs,
                                  time.perf_counter() - t0, cost, device)
        return out

    def _observe_compile(self, key, leaf_sigs, seconds: float,
                         cost: Optional[Dict[str, float]],
                         device: Optional[torch.device]) -> None:
        from ray_tpu_torch._private import metrics_defs as mdefs

        rec = _record(self.name)
        tags = {"program": self.name}
        retrace_from = self._detect_retrace(leaf_sigs)
        self._sigs[key] = list(leaf_sigs)
        rec.compiles += 1
        rec.compile_seconds += seconds
        cost = dict(cost or {}, device=str(device) if device else "none")
        rec.cost = cost
        sig_str = _fmt_sig(leaf_sigs)
        rec.signatures[key] = {"signature": sig_str, "seconds": seconds,
                               **cost}
        mdefs.XLA_COMPILES.inc(tags=tags)
        mdefs.XLA_COMPILE_SECONDS.observe(seconds, tags=tags)
        if cost.get("flops"):
            mdefs.XLA_PROGRAM_FLOPS.set(cost["flops"], tags=tags)
        if cost.get("bytes_accessed"):
            mdefs.XLA_PROGRAM_BYTES.set(cost["bytes_accessed"], tags=tags)
        if retrace_from is not None:
            rec.retraces += 1
            mdefs.XLA_RETRACES.inc(tags=tags)
            logger.warning(
                "retrace: %s compiled for a new signature (policy=%s)\n"
                "  was: %s\n  now: %s", self.name, self.shape_policy,
                _fmt_sig(retrace_from), sig_str)

    def _detect_retrace(self, leaf_sigs) -> Optional[List[Tuple]]:
        """The closest prior signature when this compile is a retrace,
        else None. Runs before the new signature is recorded."""
        if self.shape_policy == "free" or not self._sigs:
            return None
        prior = list(self._sigs.values())
        if self.shape_policy == "static":
            return prior[-1]
        # bucketed: expected growth = every changed dim is a power of
        # two (or explicitly allowed, e.g. a non-pow2 max_len cap).
        best = prior[-1]
        for old in prior:
            dims = _changed_dims(old, leaf_sigs)
            if dims is None:
                continue
            if all(_is_pow2(d) or d in self.allowed_dims for d in dims):
                return None
            best = old
        return best

    # ------------------------------------------------------------- timing
    def _note_cadence(self) -> None:
        now = time.perf_counter()
        prev, self._last_call = self._last_call, now
        if prev is not None and not self._external_timing:
            dt = now - prev
            if dt > 0:
                _set_achieved(_record(self.name),
                              self._cost_for(self._last_key), dt)

    def note_execution(self, seconds: float,
                       bytes_hint: Optional[float] = None
                       ) -> Optional[Dict[str, float]]:
        """Feed back a MEASURED wall time for the most recent call (the
        engine's tick measures dispatch to fetch, prefill dispatch to the
        first token's sync, the async loop its window over its steps).
        Disables the cadence fallback for this wrapper and returns the
        achieved figures. ``bytes_hint`` replaces the counted bytes for
        a program whose real traffic is data-dependent (a paged tick
        reads only the live blocks)."""
        self._external_timing = True
        if seconds <= 0:
            return None
        cost = self._cost_for(self._last_key)
        if bytes_hint is not None and bytes_hint > 0:
            cost = dict(cost) if cost else {}
            cost["bytes_accessed"] = float(bytes_hint)
        return _set_achieved(_record(self.name), cost, seconds)

    def _cost_for(self, key) -> Optional[Dict[str, Any]]:
        rec = _programs.get(self.name)
        if rec is None:
            return None
        if key is not None and key in rec.signatures:
            return rec.signatures[key]
        return rec.cost


def _set_achieved(rec: _ProgramRecord, cost, seconds: float
                  ) -> Optional[Dict[str, float]]:
    if not cost:
        return None
    from ray_tpu_torch._private import metrics_defs as mdefs

    tags = {"program": rec.name}
    out: Dict[str, float] = {}
    flops = cost.get("flops")
    nbytes = cost.get("bytes_accessed")
    if flops:
        out["achieved_flops_per_s"] = flops / seconds
        mdefs.XLA_ACHIEVED_FLOPS.set(out["achieved_flops_per_s"],
                                     tags=tags)
        peak = _device_peak_flops(cost.get("device", ""))
        if peak:
            out["model_flops_utilization"] = flops / seconds / peak
            mdefs.XLA_MFU.set(out["model_flops_utilization"], tags=tags)
    if nbytes:
        out["achieved_bandwidth_bytes_per_s"] = nbytes / seconds
        mdefs.XLA_ACHIEVED_BW.set(
            out["achieved_bandwidth_bytes_per_s"], tags=tags)
    return out or None


_peak_cache: Dict[str, Optional[float]] = {}


def _device_peak_flops(device: str) -> Optional[float]:
    """The peak of the card ``device`` names (``cuda:<n>``), None for
    another device or an unknown card."""
    if not device.startswith("cuda"):
        return None
    if device not in _peak_cache:
        peak = None
        try:
            kind = torch.cuda.get_device_name(torch.device(device))
            for name, flops in PEAK_FLOPS.items():
                if kind.startswith(name):
                    peak = flops
                    break
        except Exception:  # noqa: BLE001 - no such card
            pass
        _peak_cache[device] = peak
    return _peak_cache[device]


def instrument(fn=None, *, name: Optional[str] = None,
               shape_policy: str = "static",
               allowed_dims: Sequence[int] = (), device=None, cost=None):
    """``fn`` through the monitor (usable as a decorator)."""
    if fn is None:
        return functools.partial(instrument, name=name,
                                 shape_policy=shape_policy,
                                 allowed_dims=allowed_dims, device=device,
                                 cost=cost)
    return InstrumentedProgram(fn, name or getattr(fn, "__name__", "fn"),
                               shape_policy=shape_policy,
                               allowed_dims=allowed_dims, device=device,
                               cost=cost)


# -------------------------------------------------------- device memory
def sample_device_memory(node_id: Optional[str] = None
                         ) -> List[Dict[str, Any]]:
    """Per-card memory vitals as tagged gauges: ``bytes_in_use`` and
    ``peak_bytes_in_use`` from ``torch.cuda.memory_stats`` (this
    process's allocator), ``bytes_limit`` the card's total from
    ``mem_get_info``, and ``bytes_free`` the card's free bytes. A process
    that has not initialized CUDA reports ``[]`` (sampling must not take
    a card), and so does the CPU."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    from ray_tpu_torch._private import metrics_defs as mdefs

    node = (node_id or "local")[:12]
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except Exception:  # noqa: BLE001 - a card this process cannot use
            continue
        tags = {"node_id": node, "device": f"cuda:{i}"}
        entry: Dict[str, Any] = {"device": tags["device"],
                                 "kind": torch.cuda.get_device_name(i),
                                 "bytes_free": int(free)}
        for field, value, gauge in (
                ("bytes_in_use", stats.get("allocated_bytes.all.current"),
                 mdefs.DEVICE_MEM_USED),
                ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak"),
                 mdefs.DEVICE_MEM_PEAK),
                ("bytes_limit", total, mdefs.DEVICE_MEM_LIMIT)):
            if value is not None:
                gauge.set(float(value), tags=tags)
                entry[field] = int(value)
        out.append(entry)
    return out


# --------------------------------------------------------- capture plane
def capture(cmd: Dict[str, Any]) -> Dict[str, Any]:
    """Run one ``torch.profiler`` capture in this process for
    ``cmd["duration_s"]`` and write its Chrome trace under
    ``<dir>/profiles/<capture_id>/<tag>/``, ``dir`` being ``cmd["dir"]``
    (the requesting process's session dir) or this process's. Returns the record:
    ``status`` (done, failed, or busy when a capture is already running
    here), ``trace_dir``, ``files``, and the names of the device kernels
    the trace holds with their counts (``kernels``), and the trace's
    events by category (``events``)."""
    from ray_tpu_torch._private import metrics_defs as mdefs

    capture_id = str(cmd.get("capture_id") or "cap-unnamed")
    duration = max(float(cmd.get("duration_s", 2.0)), 0.1)
    tag = f"{cmd.get('tag') or 'local'}-{os.getpid()}"
    record: Dict[str, Any] = {
        "capture_id": capture_id, "tag": tag, "pid": os.getpid(),
        "duration_s": duration, "ts": time.time()}
    if not _capture_lock.acquire(blocking=False):
        record.update(status="busy",
                      error="a capture is already in progress")
        return record
    try:
        from torch.profiler import ProfilerActivity, profile

        trace_dir = os.path.join(cmd.get("dir") or session_dir(),
                                 "profiles", capture_id, tag)
        os.makedirs(trace_dir, exist_ok=True)
        record["trace_dir"] = trace_dir
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            time.sleep(duration)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        kernels: Dict[str, int] = {}
        events: Dict[str, int] = {}
        for ev in trace.get("traceEvents", []):
            cat = str(ev.get("cat"))
            events[cat] = events.get(cat, 0) + 1
            if cat == "kernel":
                kernels[ev["name"]] = kernels.get(ev["name"], 0) + 1
        files = sum(len(fs) for _, _, fs in os.walk(trace_dir))
        record.update(status="done", files=files, kernels=kernels,
                      events=events, end_ts=time.time())
        mdefs.PROFILE_CAPTURES.inc(tags={"status": "done"})
    except Exception as e:  # noqa: BLE001
        record.update(status="failed", error=repr(e), end_ts=time.time())
        mdefs.PROFILE_CAPTURES.inc(tags={"status": "failed"})
        logger.exception("profile capture %s failed", capture_id)
    finally:
        _capture_lock.release()
    return record


def _targets(target: str):
    """The live replica processes ``target`` names: ``"*"`` every
    deployment's, a deployment name its replicas, else the replica whose
    id it is."""
    from ray_tpu_torch.serve import api

    ctl = api._controller
    if ctl is None:
        return []
    names = list(ctl.list_deployments())
    replicas = [r for n in names for r in ctl.get_replicas(n)
                if r.alive and r.ready]
    if target in ("", "*", "all"):
        return replicas
    if target in names:
        return [r for r in replicas if r.name == target]
    return [r for r in replicas if r.replica_id == target]


def request_capture(target: str = "*", duration_s: float = 2.0,
                    capture_id: Optional[str] = None) -> str:
    """Send a capture command to the replica processes ``target`` names
    (``"*"``, a deployment, or a replica id), over each one's control
    pipe; ``"local"`` captures this process. Every trace goes under this
    process's :func:`session_dir`. Returns the capture id at once: each
    process's record is registered (``status`` "capturing", then "done"
    or "failed") for :func:`list_captures`."""
    if not capture_id:
        capture_id = (f"cap-{int(time.time())}-{os.getpid() % 10000:04d}"
                      f"-{next(_capture_seq)}")
    cmd = {"capture_id": capture_id, "duration_s": float(duration_s),
           "dir": session_dir()}

    def register(key: str, record: Dict[str, Any]) -> None:
        with _state_lock:
            _captures[key] = record

    if target == "local":
        key = f"{capture_id}/local"
        register(key, {"capture_id": capture_id, "status": "capturing",
                       "ts": time.time()})
        threading.Thread(target=lambda: register(key, capture(cmd)),
                         daemon=True, name="profile-capture").start()
        return capture_id
    for r in _targets(target):
        key = f"{capture_id}/{r.replica_id}"
        register(key, {"capture_id": capture_id, "replica": r.replica_id,
                       "status": "capturing", "ts": time.time()})

        def done(fut, key=key, rid=r.replica_id):
            try:
                rec = fut.result()
            except Exception as e:  # noqa: BLE001 - the replica died
                rec = {"capture_id": capture_id, "status": "failed",
                       "error": repr(e), "ts": time.time()}
            register(key, {**rec, "replica": rid})

        r.control("capture", {**cmd, "tag": r.replica_id}) \
            .add_done_callback(done)
    return capture_id


def list_captures() -> List[Dict[str, Any]]:
    """Registered captures, newest first."""
    with _state_lock:
        out = [dict(v) for v in _captures.values()]
    out.sort(key=lambda e: e.get("ts", 0), reverse=True)
    return out


def list_programs() -> List[Dict[str, Any]]:
    """The program registry of this process (``replica`` "serving") and
    of every live replica process that answers within 5 s, sorted by
    program."""
    from concurrent.futures import wait

    out = [{**s, "replica": "serving"} for s in all_program_stats()]
    futs = [(r, r.control("programs")) for r in _targets("*")]
    wait([f for _, f in futs], timeout=5.0)
    for r, f in futs:
        if f.done() and f.exception() is None:
            out.extend({**s, "replica": r.replica_id} for s in f.result())
    out.sort(key=lambda e: (e.get("name", ""), e.get("replica", "")))
    return out


__all__ = [
    "InstrumentedProgram", "PEAK_FLOPS", "add_kernel_cost",
    "all_program_stats", "capture", "cost_active", "decode_cost",
    "flash_cost", "instrument", "list_captures", "list_programs",
    "program_stats", "request_capture", "sample_device_memory",
]
