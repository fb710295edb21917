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
``cuda`` only (they take no ``device``), so each of their replicas asks
the runtime for a card of its own (:data:`ONE_CARD`).

Not ported yet: the KV handoff between replicas behind :meth:`prefill`
and :meth:`decode_from` (``kv_transfer.send_handoff`` /
``receive_handoff`` raise naming item 6c), :func:`deploy_disagg_llama`
(item 6c), the weight-sync subscriber (item 10), and the flight event
and metrics of a weight swap (item 9).
"""

from __future__ import annotations

import logging
import queue
import threading
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.inference import LlamaGenerator

logger = logging.getLogger(__name__)

# The builders' replica options: every replica gets a card of its own
# (``CUDA_VISIBLE_DEVICES``), so N replicas do not all land on cuda:0.
ONE_CARD = {"num_gpus": 1}


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
        across the process hop); they move to the engine's device. The
        JAX package's ``rl.weight_swap`` flight event and swap metrics
        (``cause``, ``manifest``, ``run``) wait for ROADMAP item 9.
        Returns the version now live."""
        weights = _to_device(weights, self.batcher.device)
        with self._lock:
            return self.batcher.swap_params(weights, version=version)

    def enable_weight_sync(self, spec, run: str = "rl",
                           poll_s: float = 0.05,
                           target_shardings=None) -> None:
        """The trainer's weight channel and its checkpoint fallback."""
        raise llama.not_ported("enable_weight_sync (the RL weight-sync "
                               "plane)", "item 10 (ray_tpu_torch/rl)")

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
    def _open(self, submit) -> tuple:
        """Register a request (``submit()`` under the engine lock returns
        its id) and its token queue; wake the tick thread."""
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            rid = submit()
            self._queues[rid] = q
        self._work.set()
        return rid, q

    def _tokens(self, rid: int, q: "queue.Queue"):
        """Yield a request's tokens as the ticks produce them. A stream
        abandoned before its end (a client gone, a cancelled replica
        stream) cancels the request, so it stops burning decode ticks; a
        buffered engine first applies its ticks in flight
        (``_drain_in_flight``), so the cancel lands at a clean boundary."""
        done = False
        try:
            while True:
                token = q.get(timeout=300)
                if token is None:
                    done = True
                    return
                if isinstance(token, Exception):
                    done = True
                    raise token
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
        rid, q = self._open(lambda: self.batcher.submit(
            list(prompt_token_ids), max_new_tokens=int(max_tokens),
            trace=trace))
        yield from self._tokens(rid, q)

    # --------------------------------- disaggregated prefill/decode
    def prefill(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Prefill-role unary: admission and paged prefill, then the KV
        handoff. A request that finishes at its first token returns
        ``{"done": [...]}``; a parked one goes to
        ``kv_transfer.send_handoff``, whose channel between replicas
        raises naming item 6c (the parked blocks are released first)."""
        from ray_tpu_torch.serve import kv_transfer

        prompt = list(payload["prompt_token_ids"])
        max_tokens = int(payload.get("max_tokens", 16))
        resumed_tokens = int(payload.get("resumed_tokens", 0) or 0)
        if resumed_tokens and self.batcher.eos_token is not None \
                and prompt and prompt[-1] == self.batcher.eos_token:
            return {"done": []}
        trace = self._request_trace()
        rid, q = self._open(lambda: self.batcher.submit(
            prompt, max_new_tokens=max_tokens, trace=trace))
        tokens = list(self._tokens(rid, q))
        with self._lock:
            if rid not in self.batcher.handoff_ready():
                return {"done": tokens}
            try:
                return kv_transfer.send_handoff(self.batcher, rid)
            except NotImplementedError:
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
        named by ``request["manifest"]`` and stream every token, the
        prefill's first token included. ``kv_transfer.receive_handoff``
        refuses an unjournaled manifest and raises naming item 6c past
        that gate."""
        from ray_tpu_torch.serve import kv_transfer

        manifest = request["manifest"]
        ticket = request.get("reservation")
        res_id = None
        if isinstance(ticket, dict) and \
                ticket.get("nonce") == self._nonce:
            res_id = ticket.get("res_id")
        trace = self._request_trace()
        rid, q = self._open(lambda: kv_transfer.receive_handoff(
            self.batcher, manifest, reservation=res_id, trace=trace))
        yield int(manifest["first_token"])
        yield from self._tokens(rid, q)

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
    engine knobs on both sides, the paged-KV plane forced on. Binding
    only: serving them split needs the role group and the channel of
    item 6c."""
    engine_kwargs.setdefault("paged", True)
    prefill = ContinuousLlamaDeployment.options(
        name=f"{name}-prefill", num_replicas=num_prefill,
        ray_actor_options=ONE_CARD).bind(
        config=config, role="prefill", **engine_kwargs)
    decode = ContinuousLlamaDeployment.options(
        name=f"{name}-decode", num_replicas=num_decode,
        ray_actor_options=ONE_CARD).bind(
        config=config, role="decode", **engine_kwargs)
    return prefill, decode


def deploy_disagg_llama(name: str = "llm",
                        config: Optional[llama.LlamaConfig] = None,
                        num_prefill: int = 1, num_decode: int = 1,
                        **engine_kwargs) -> Dict[str, str]:
    """A disaggregated (prefill, decode) pair behind one role group."""
    raise llama.not_ported(
        "deploy_disagg_llama (role groups and the KV channel)",
        "item 6c (the prefill/decode split over the serve runtime)")


from ray_tpu_torch.llm.batch import LLMBatchWorker, batch_generate  # noqa: E402

__all__ = ["ContinuousLlamaDeployment", "LLMBatchWorker", "LlamaDeployment",
           "batch_generate", "build_continuous_llama_app",
           "build_disagg_llama_apps", "build_llama_app",
           "deploy_disagg_llama"]
