"""ray_tpu_torch.llm: LLM serving and batch inference on the port's serve
runtime (the port of ``ray_tpu/llm/__init__.py``).

* :class:`LlamaDeployment` wraps a
  :class:`~ray_tpu_torch.models.inference.LlamaGenerator`, with
  ``@serve.batch`` merging concurrent requests into one left-padded
  batched generate;
* :class:`ContinuousLlamaDeployment` owns a
  :class:`~ray_tpu_torch.models.continuous_batching.ContinuousBatcher`
  stepped by a tick thread of its own: requests join mid-flight and
  stream tokens as the ticks produce them (on the card, the paged decode
  kernel carries every tick).

Both take ``device=None``, meaning ``cuda``, which raises with no GPU
(pass ``device="cpu"`` for the plain path). Used in process through
``Deployment._cls_or_fn``, or served from replica processes with
``serve.run(build_continuous_llama_app(...))``. The builders serve on
``cuda`` only (they take no ``device``): a colocated replica asks the
runtime for a card of its own (:data:`ONE_CARD`); a disaggregated pair's
replicas ask half a card each (:data:`HALF_CARD`), so one prefill and
one decode replica share a card, as the JAX package's pair shares its
host's chip.

:func:`deploy_disagg_llama` serves the prefill/decode split: a prefill
replica runs :meth:`ContinuousLlamaDeployment.prefill` and hands the KV
blocks off through a shm channel (``kv_transfer.send_handoff``); a
decode replica streams every token from
:meth:`ContinuousLlamaDeployment.decode_from`. The replica lifecycle's
chaos sites (``serve_replica``, ``phase=prefill|decode``) are JAX's.

A weight swap emits JAX's ``rl.weight_swap`` flight event and counts
``RL_SWAPS`` and ``RL_VERSION``. :meth:`ContinuousLlamaDeployment.
enable_weight_sync` keeps a replica current with a trainer's
:class:`~ray_tpu_torch.rl.weight_sync.WeightPublisher` (the channel's
fast path, the checkpoint's slow path), and
:meth:`~ContinuousLlamaDeployment.restore_weights` brings a replica
current from a publish's checkpoint on command.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch._private import chaos
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.inference import LlamaGenerator

logger = logging.getLogger(__name__)

# The builders' replica options: a colocated replica gets a card of its
# own (``CUDA_VISIBLE_DEVICES``), so N replicas do not all land on
# cuda:0; a disaggregated pair's prefill and decode replica share one.
ONE_CARD = {"num_gpus": 1}
HALF_CARD = {"num_gpus": 0.5}


class _FairLock:
    """A lock taken in arrival order: a thread that releases it and takes
    it again at once queues behind the threads already waiting. The
    engine's tick thread re-takes its lock right after every step; with a
    plain ``threading.Lock`` it barges back in ahead of a caller waiting
    to submit, which then waits many ticks for its turn."""

    def __init__(self):
        self._cond = threading.Condition()
        self._next = 0
        self._serving = 0

    def __enter__(self):
        with self._cond:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cond.wait()

    def __exit__(self, *exc):
        with self._cond:
            self._serving += 1
            self._cond.notify_all()


def _to_device(tree, device):
    """A dict tree of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@serve.deployment
class LlamaDeployment:
    """Batched text-completion replica (token-id interface; tokenizers are
    the caller's concern, as in the reference's processor configs)."""

    def __init__(self, config: Optional[llama.LlamaConfig] = None,
                 params=None, max_len: int = 512,
                 max_batch_size: int = 8,
                 checkpoint_path: Optional[str] = None, device=None):
        self.config = config or llama.LlamaConfig.tiny()
        if params is None and checkpoint_path:
            params = _params_from_checkpoint(checkpoint_path, self.config,
                                             device)
        self.generator = LlamaGenerator(self.config, params=params,
                                        max_len=max_len, device=device)
        self.max_batch_size = max_batch_size

    @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.02)
    def __call__(self, requests: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        # Pad prompts to a common length, run one batched generate.
        prompts = [np.asarray(r["prompt_token_ids"], np.int32)
                   for r in requests]
        max_new = max(int(r.get("max_tokens", 16)) for r in requests)
        temperature = float(requests[0].get("temperature", 0.0))
        plen = max(len(p) for p in prompts)
        batch = np.zeros((len(prompts), plen), np.int32)
        for i, p in enumerate(prompts):
            batch[i, plen - len(p):] = p  # left-pad with zeros, as JAX
        out = self.generator.generate(
            batch, max_new_tokens=max_new,
            temperature=temperature).cpu().numpy()
        return [
            {"token_ids": out[i, : int(r.get("max_tokens", 16))].tolist()}
            for i, r in enumerate(requests)
        ]


def _params_from_checkpoint(path: str, config: llama.LlamaConfig,
                            device=None):
    """Cold-start params from a training run's committed checkpoint
    (:func:`ray_tpu_torch.checkpoint.load_latest`: the newest committed
    manifest under ``path``, written by either package; ``config``'s
    param paths read a step the JAX package wrote), on ``device``. A
    saved ``TrainState`` contributes its ``params``; a bare params tree
    loads as it is."""
    from ray_tpu_torch.checkpoint import load_latest
    from ray_tpu_torch.checkpoint.plane import key_paths

    device = llama.default_device(device)
    state = load_latest(path, param_paths=key_paths(
        llama.param_shapes(config)))
    return _to_device(getattr(state, "params", state), device)


def build_llama_app(config: Optional[llama.LlamaConfig] = None,
                    num_replicas: int = 1, max_len: int = 512,
                    checkpoint_path: Optional[str] = None):
    dep = LlamaDeployment.options(num_replicas=num_replicas,
                                  ray_actor_options=ONE_CARD)
    return dep.bind(config, None, max_len,
                    checkpoint_path=checkpoint_path)


@serve.deployment
class ContinuousLlamaDeployment:
    """Continuous-batching completion replica: one shared slot pool per
    replica; requests join mid-flight and stream tokens as decode ticks
    produce them. Use with handle ``stream=True`` (or plain calls for
    full completions)."""

    def __init__(self, config: Optional[llama.LlamaConfig] = None,
                 params=None, num_slots: int = 8, max_len: int = 512,
                 eos_token: Optional[int] = None, sync_every: int = 1,
                 use_decode_kernel: Optional[bool] = None,
                 paged: Optional[bool] = None, block_size: int = 64,
                 kv_dtype: Optional[str] = None,
                 num_blocks: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 sampling=None,
                 spec_k: Optional[int] = None,
                 spec_draft_layers: Optional[int] = None,
                 spec_adaptive: Optional[bool] = None,
                 checkpoint_path: Optional[str] = None,
                 role: Optional[str] = None, device=None):
        """The engine knobs pass straight to the ContinuousBatcher and are
        overridable per deploy through ``init_kwargs``. ``params=None``
        draws random weights from seed 0 on the device (or cold-starts
        from ``checkpoint_path``'s newest committed checkpoint).

        The engine is stepped by one tick thread under one lock, which
        every caller thread takes too (submit, cancel, pressure, scoring,
        swaps): a swap lands strictly between ticks, and a caller gets the
        lock at the next tick boundary (a FIFO lock). The tick thread and
        the callers all use the device's default stream (the port sets no
        other), so the tensors they hand over are ordered."""
        from ray_tpu_torch.models.continuous_batching import \
            ContinuousBatcher

        self.config = config or llama.LlamaConfig.tiny()
        if params is None and checkpoint_path:
            params = _params_from_checkpoint(checkpoint_path, self.config,
                                             device)
        self._queues: Dict[int, "queue.Queue"] = {}
        self._lock = _FairLock()
        self._work = threading.Event()
        # Notified when a tick finishes requests: an import waiting for
        # a free decode slot retries.
        self._slot_freed = threading.Condition()
        self._closed = False
        self.batcher = ContinuousBatcher(
            self.config, params=params, num_slots=num_slots,
            max_len=max_len, eos_token=eos_token,
            token_callback=self._on_token, sync_every=sync_every,
            use_decode_kernel=use_decode_kernel, paged=paged,
            block_size=block_size, kv_dtype=kv_dtype,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            sampling=sampling, spec_k=spec_k,
            spec_draft_layers=spec_draft_layers,
            spec_adaptive=spec_adaptive, role=role, device=device)
        # Reservation tickets are engine-local ids; the nonce scopes a
        # ticket to THIS replica, so a ticket spent against another
        # replica's arena is refused.
        self._nonce = uuid.uuid4().hex[:16]
        self._ticker = threading.Thread(target=self._tick_loop, daemon=True,
                                        name="llm-ticks")
        self._ticker.start()

    def _on_token(self, rid: int, token: int) -> None:
        q = self._queues.get(rid)
        if q is not None:
            q.put(token)

    def _tick_loop(self) -> None:
        while True:
            self._work.wait()
            try:
                with self._lock:
                    if self._closed:
                        return
                    if not self.batcher.has_work():
                        self._work.clear()
                        continue
                    finished = self.batcher.step()
                for rid in finished:
                    q = self._queues.get(rid)
                    if q is not None:
                        q.put(None)  # end-of-stream
                if finished:
                    with self._slot_freed:
                        self._slot_freed.notify_all()
            except Exception as e:  # noqa: BLE001 — the engine's boundary
                # Engine error (OOM, a bad request reaching the kernel):
                # fail every in-flight stream explicitly and reset the
                # slot pool, instead of dying silently and leaving
                # clients blocked on their queues.
                logger.exception("continuous-batching tick failed; "
                                 "aborting in-flight requests")
                with self._lock:
                    self.batcher.reset()
                    queues = dict(self._queues)
                for q in queues.values():
                    q.put(e)

    def close(self) -> None:
        """Stop the tick thread and end every open stream with an error.
        A deployment held in process frees its engine this way: the
        engine's token callback is the only reference back to the
        deployment, so once it is dropped the last reference to either
        frees the device memory at once (a replica process ends with its
        process)."""
        with self._lock:
            self._closed = True
            queues = dict(self._queues)
        self._work.set()
        self._ticker.join(timeout=60)
        self.batcher.token_callback = None
        for q in queues.values():
            q.put(RuntimeError("the deployment was closed"))

    @staticmethod
    def _request_trace() -> Optional[Dict[str, Any]]:
        """The serve request context of the CALLING request (set by the
        replica before user code runs; it rides the contextvar through
        the sync executor hop), as the engine's trace dict. The tenant
        falls back to the multiplexed model id."""
        from ray_tpu_torch.serve import multiplex
        from ray_tpu_torch.serve.context import get_request_context

        rctx = get_request_context()
        if rctx is None:
            return None
        trace = dict(rctx)
        trace.setdefault("tenant", multiplex.get_request_tenant())
        return trace

    def pressure(self) -> Dict[str, Any]:
        """Live engine pressure (queue depth, KV blocks free, in-flight
        prefill tokens: the router's affinity and shedding input). Under
        the engine lock: the snapshot iterates the waiting queue, which
        the tick thread mutates."""
        with self._lock:
            return self.batcher.pressure_snapshot()

    # ---------------------------------------------------- weight swaps
    def weight_version(self) -> int:
        """Version of the params currently serving (0 = cold-start)."""
        return self.batcher.weight_version

    def swap_weights(self, weights, version: Optional[int] = None,
                     cause: str = "publish", manifest: Optional[dict] = None,
                     run: Optional[str] = None) -> int:
        """Swap the live params at a tick boundary: taking the engine lock
        is the guarantee, so in-flight requests keep their KV and go on
        under the new weights. ``weights`` may be host tensors (a caller
        across the process hop); they move to the engine's device. Emits
        the ``rl.weight_swap`` flight event (caused by the trainer's
        publish event when a ``manifest`` carries its ``event_id``) and
        counts the swap by ``cause``. Returns the version now live."""
        manifest = manifest or {}
        run = run or manifest.get("run") or "rl"
        t0 = time.perf_counter()
        weights = _to_device(weights, self.batcher.device)
        with self._lock:
            v = self.batcher.swap_params(weights, version=version)
        self._last_swap_s = time.perf_counter() - t0
        attrs = {"version": v, "swap_cause": cause}
        if manifest.get("ts"):
            # Trainer publish to generator live, end to end.
            attrs["e2e_seconds"] = round(
                max(time.time() - float(manifest["ts"]), 0.0), 6)
        _events.emit("rl.weight_swap", cause=manifest.get("event_id", ""),
                     subject={"run": run}, **attrs)
        mdefs.RL_SWAPS.inc(tags={"run": run, "cause": cause})
        mdefs.RL_VERSION.set(v, tags={"run": run, "role": "generator"})
        return v

    def enable_weight_sync(self, spec, run: str = "rl",
                           poll_s: float = 0.05,
                           target_shardings=None, kv=None) -> None:
        """Start the subscriber's poll thread: the fast path reads the
        trainer's weight channel (``spec``: a reader attach-spec from
        ``WeightPublisher.subscriber_spec``, or a ``WeightSubscriber``),
        and when it breaks (writer gone, a payload failing its crc) the
        ladder restores the newest manifest's checkpoint (found in
        ``kv``'s ``__rl__`` mirror); both land through
        :meth:`swap_weights`, never mid-tick."""
        from ray_tpu_torch.rl.weight_sync import WeightSubscriber

        if spec is None and kv is None:
            raise ValueError("enable_weight_sync needs a channel spec (or "
                             "a kv whose __rl__ mirror names checkpoints)")
        self.disable_weight_sync()
        sub = (spec if isinstance(spec, WeightSubscriber)
               else WeightSubscriber(spec, run=run,
                                     target_shardings=target_shardings,
                                     kv=kv))
        self._subscriber = sub
        stop = self._sync_stop = threading.Event()

        def _loop():
            while not stop.is_set():
                try:
                    got = sub.poll(timeout=poll_s)
                except Exception:  # noqa: BLE001 - fast path down
                    try:
                        manifest, params = sub.restore_fallback()
                        if int(manifest["version"]) > \
                                self.batcher.weight_version:
                            self.swap_weights(
                                params, version=int(manifest["version"]),
                                cause="fallback", manifest=manifest,
                                run=run)
                    except Exception:  # noqa: BLE001
                        logger.exception("rl: weight-sync fallback failed")
                    stop.wait(max(poll_s, 0.05))
                    continue
                if got is None:
                    continue
                manifest, params = got
                self.swap_weights(params, version=int(manifest["version"]),
                                  cause="publish", manifest=manifest,
                                  run=run)

        self._sync_thread = threading.Thread(target=_loop, daemon=True,
                                             name="rl-weight-sync")
        self._sync_thread.start()

    def disable_weight_sync(self) -> None:
        stop = getattr(self, "_sync_stop", None)
        if stop is not None:
            stop.set()

    def sync_timing(self) -> Dict[str, float]:
        """The newest swap's split: the subscriber's read and crc seconds
        and the swap's (device copy and the engine lock), as
        ``{"read_s", "crc_s", "swap_s"}``."""
        sub = getattr(self, "_subscriber", None)
        out = dict(sub.last_timing) if sub is not None else {}
        out["swap_s"] = getattr(self, "_last_swap_s", 0.0)
        return out

    def restore_weights(self, manifest: Dict[str, Any]) -> int:
        """The slow path on command: restore ``manifest``'s version from
        its checkpoint in this process (``WeightSubscriber.
        restore_fallback``) and swap it in with cause ``fallback``. JAX's
        caller loads the checkpoint itself and sends the params through
        ``swap_weights``; here the params never cross the process hop.
        Returns the version now live."""
        from ray_tpu_torch.rl.weight_sync import WeightSubscriber

        run = manifest.get("run") or "rl"
        sub = getattr(self, "_subscriber", None) or WeightSubscriber(
            None, run=run)
        manifest, params = sub.restore_fallback(manifest)
        return self.swap_weights(params, version=int(manifest["version"]),
                                 cause="fallback", manifest=manifest,
                                 run=run)

    def score_logprobs(self, prompt_token_ids,
                       token_ids) -> List[float]:
        """Teacher-forced logprobs of ``token_ids`` after
        ``prompt_token_ids`` under the CURRENT live params (the flash
        forward kernel on the card). Under the engine lock, so the params
        cannot swap mid-score."""
        with self._lock:
            lp = self.batcher.score_logprobs(list(prompt_token_ids),
                                             list(token_ids))
        return [float(x) for x in lp]

    # ---------------------------------------------------------- streams
    def _open(self, submit, ready=None) -> tuple:
        """Register a request (``submit()`` under the engine lock returns
        its id) and its token queue; wake the tick thread. With
        ``ready``, the submit waits until ``ready()`` holds under the
        lock: an import waits for a free decode slot as a submit waits
        in the engine's queue (its bytes wait in their channel)."""
        q: "queue.Queue" = queue.Queue()
        while True:
            with self._lock:
                if ready is None or ready():
                    rid = submit()
                    self._queues[rid] = q
                    break
            with self._slot_freed:
                self._slot_freed.wait(timeout=0.05)
        self._work.set()
        return rid, q

    def _tokens(self, rid: int, q: "queue.Queue",
                emitted: Optional[int] = None,
                first: Optional[int] = None):
        """Yield a request's tokens as the ticks produce them. A stream
        abandoned before its end (a client gone, a cancelled replica
        stream) cancels the request, so it stops burning decode ticks; a
        buffered engine first applies its ticks in flight
        (``_drain_in_flight``), so the cancel lands at a clean boundary.
        With ``emitted`` (the tokens this stream already delivered), the
        chaos site ``serve_replica``/``phase=decode,token=N`` fires
        before the Nth token's yield: a rule with ``token=N`` dies with
        exactly N tokens delivered. ``first`` is a token yielded before
        the queue's (an imported request's, produced by the prefill)."""
        done = False
        try:
            if first is not None:
                if emitted is not None:
                    if chaos.enabled():
                        chaos.inject("serve_replica", phase="decode",
                                     token=emitted)
                    emitted += 1
                yield first
            while True:
                token = q.get(timeout=300)
                if token is None:
                    done = True
                    return
                if isinstance(token, Exception):
                    done = True
                    raise token
                if emitted is not None:
                    if chaos.enabled():
                        chaos.inject("serve_replica", phase="decode",
                                     token=emitted)
                    emitted += 1
                yield token
        finally:
            self._queues.pop(rid, None)
            if not done:
                with self._lock:
                    self.batcher._drain_in_flight()
                    self.batcher.cancel(rid)

    def generate(self, prompt_token_ids, max_tokens: int = 16):
        """Streaming generator of token ids (serve ``stream=True``).
        Accepts the token-id list or the ingress payload dict
        (``{"prompt_token_ids": [...], "max_tokens": N}``), which is what
        the HTTP streaming route hands through and what the recovery
        journal resubmits."""
        resumed_tokens = 0
        if isinstance(prompt_token_ids, dict):
            payload = prompt_token_ids
            prompt_token_ids = payload["prompt_token_ids"]
            max_tokens = payload.get("max_tokens", max_tokens)
            resumed_tokens = int(payload.get("resumed_tokens", 0) or 0)
        if resumed_tokens and self.batcher.eos_token is not None \
                and prompt_token_ids \
                and prompt_token_ids[-1] == self.batcher.eos_token:
            # A mid-decode RESUME whose last delivered token was EOS: the
            # generation had finished; only the end-of-stream died with
            # the replica. (An ORIGINAL prompt may end with EOS.)
            return
        trace = self._request_trace()
        if chaos.enabled():
            # Queued or prefilling: nothing streamed yet.
            chaos.inject("serve_replica", phase="prefill",
                         tokens=len(prompt_token_ids))
        rid, q = self._open(lambda: self.batcher.submit(
            list(prompt_token_ids), max_new_tokens=int(max_tokens),
            trace=trace))
        yield from self._tokens(rid, q, emitted=0)

    # --------------------------------- disaggregated prefill/decode
    def prefill(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Prefill-role unary: admission and paged prefill for the
        payload, then the KV handoff. Returns the transfer's manifest
        (the staging bytes wait in a shm channel; the manifest carries
        its reader attach-spec): the router journals it and opens the
        decode stream. A request that finishes at its first token
        (``max_tokens == 1``, an EOS first token, or a resumed prompt
        already ending in EOS) returns ``{"done": [...]}``: nothing to
        hand off.

        Chaos: ``serve_replica``/``phase=prefill`` before the submit
        (nothing journaled: the router resubmits) and
        ``kv_transfer``/``stage=export`` inside the export (a prefill
        death mid-export: the same resubmit)."""
        from ray_tpu_torch.serve import kv_transfer

        prompt = list(payload["prompt_token_ids"])
        max_tokens = int(payload.get("max_tokens", 16))
        resumed_tokens = int(payload.get("resumed_tokens", 0) or 0)
        if resumed_tokens and self.batcher.eos_token is not None \
                and prompt and prompt[-1] == self.batcher.eos_token:
            return {"done": []}
        trace = self._request_trace()
        if chaos.enabled():
            chaos.inject("serve_replica", phase="prefill",
                         tokens=len(prompt))
        rid, q = self._open(lambda: self.batcher.submit(
            prompt, max_new_tokens=max_tokens, trace=trace))
        tokens = list(self._tokens(rid, q))
        with self._lock:
            if rid not in self.batcher.handoff_ready():
                return {"done": tokens}
            try:
                return kv_transfer.send_handoff(
                    self.batcher, rid,
                    deployment=(trace or {}).get("deployment", ""))
            except Exception:
                # The parked blocks go back to the arena: nothing will
                # collect them.
                self.batcher.abandon_handoff(rid)
                raise

    def reserve_kv(self, prompt_len: int, max_new: int):
        """Pre-reserve decode arena blocks for an incoming handoff.
        Returns a replica-scoped ticket, or None when the arena cannot
        cover it."""
        with self._lock:
            res = self.batcher.reserve_import(int(prompt_len),
                                              int(max_new))
        if res is None:
            return None
        return {"res_id": res, "nonce": self._nonce}

    def cancel_reserve(self, ticket) -> bool:
        if not isinstance(ticket, dict) or \
                ticket.get("nonce") != self._nonce:
            return False
        with self._lock:
            return self.batcher.cancel_reservation(ticket["res_id"])

    def decode_from(self, request: Dict[str, Any]):
        """Decode-role streaming entry: collect the journaled KV handoff
        named by ``request["manifest"]`` (the channel read, the crc
        check, the scatter into reserved blocks, the radix insert) and
        stream every token, the prefill's first token included. It
        reaches the caller only through this stream, so the router's
        journal stays the one ledger of what was delivered.
        ``kv_transfer.receive_handoff`` refuses an unjournaled manifest.

        Chaos: ``kv_transfer``/``stage=import`` inside the import (a
        decode death after the journaled handoff: the router replays a
        fresh prefill) and ``serve_replica``/``phase=decode,token=N``
        before each token."""
        from ray_tpu_torch.serve import kv_transfer

        manifest = request["manifest"]
        ticket = request.get("reservation")
        res_id = None
        if isinstance(ticket, dict) and \
                ticket.get("nonce") == self._nonce:
            res_id = ticket.get("res_id")
        trace = self._request_trace()
        if not manifest.get("journaled"):
            # Refused before anything waits (receive_handoff's gate).
            kv_transfer.receive_handoff(self.batcher, manifest)
        # The engine's first-token callback fires during the import,
        # before the queue is registered under the fresh id: the
        # manifest's first token is delivered here instead.
        rid, q = self._open(lambda: kv_transfer.receive_handoff(
            self.batcher, manifest, reservation=res_id, trace=trace,
            deployment=(trace or {}).get("deployment", "")),
            ready=lambda: self.batcher.free_slots > 0)
        yield from self._tokens(rid, q, emitted=0,
                                first=int(manifest["first_token"]))

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Non-streaming completion."""
        tokens = list(self.generate(request["prompt_token_ids"],
                                    request.get("max_tokens", 16)))
        return {"token_ids": tokens}


def build_continuous_llama_app(config: Optional[llama.LlamaConfig] = None,
                               num_replicas: int = 1, num_slots: int = 8,
                               max_len: int = 512, sync_every: int = 1,
                               use_decode_kernel: Optional[bool] = None,
                               paged: Optional[bool] = None,
                               block_size: int = 64,
                               kv_dtype: Optional[str] = None,
                               num_blocks: Optional[int] = None,
                               prefix_cache: Optional[bool] = None,
                               sampling=None,
                               spec_k: Optional[int] = None,
                               spec_draft_layers: Optional[int] = None,
                               spec_adaptive: Optional[bool] = None,
                               checkpoint_path: Optional[str] = None):
    dep = ContinuousLlamaDeployment.options(num_replicas=num_replicas,
                                            ray_actor_options=ONE_CARD)
    # Keyword bind so per-deploy ``init_kwargs`` overrides can retarget
    # any engine knob without positional conflicts.
    return dep.bind(config=config, num_slots=num_slots, max_len=max_len,
                    sync_every=sync_every,
                    use_decode_kernel=use_decode_kernel, paged=paged,
                    block_size=block_size, kv_dtype=kv_dtype,
                    num_blocks=num_blocks, prefix_cache=prefix_cache,
                    sampling=sampling, spec_k=spec_k,
                    spec_draft_layers=spec_draft_layers,
                    spec_adaptive=spec_adaptive,
                    checkpoint_path=checkpoint_path)


def build_disagg_llama_apps(name: str = "llm",
                            config: Optional[llama.LlamaConfig] = None,
                            num_prefill: int = 1, num_decode: int = 1,
                            **engine_kwargs):
    """(prefill_app, decode_app) Application pair for disaggregated
    serving, named ``<name>-prefill`` / ``<name>-decode``: the same
    engine knobs on both sides (the import refuses another block size,
    KV dtype or model), the paged-KV plane forced on (a role hands off
    arena blocks). Each replica asks half a card (:data:`HALF_CARD`), so
    a pair shares one. Deploy both and declare the role group, or use
    :func:`deploy_disagg_llama`, which does all three."""
    engine_kwargs.setdefault("paged", True)
    prefill = ContinuousLlamaDeployment.options(
        name=f"{name}-prefill", num_replicas=num_prefill,
        ray_actor_options=HALF_CARD).bind(
        config=config, role="prefill", **engine_kwargs)
    decode = ContinuousLlamaDeployment.options(
        name=f"{name}-decode", num_replicas=num_decode,
        ray_actor_options=HALF_CARD).bind(
        config=config, role="decode", **engine_kwargs)
    return prefill, decode


def deploy_disagg_llama(name: str = "llm",
                        config: Optional[llama.LlamaConfig] = None,
                        num_prefill: int = 1, num_decode: int = 1,
                        **engine_kwargs) -> Dict[str, str]:
    """Deploy a disaggregated (prefill, decode) pair and register the
    role group under the logical ``name``: streaming requests to
    ``/<name>/stream/...`` classify and split at the ingress from then
    on. Returns the group's mapping."""
    prefill_app, decode_app = build_disagg_llama_apps(
        name=name, config=config, num_prefill=num_prefill,
        num_decode=num_decode, **engine_kwargs)
    serve.run(prefill_app)
    serve.run(decode_app)
    serve.register_role_group(name, prefill=f"{name}-prefill",
                              decode=f"{name}-decode")
    return {"prefill": f"{name}-prefill", "decode": f"{name}-decode"}


from ray_tpu_torch.llm.batch import LLMBatchWorker, batch_generate  # noqa: E402

__all__ = ["ContinuousLlamaDeployment", "HALF_CARD", "LLMBatchWorker",
           "LlamaDeployment", "ONE_CARD",
           "batch_generate", "build_continuous_llama_app",
           "build_disagg_llama_apps", "build_llama_app",
           "deploy_disagg_llama"]
