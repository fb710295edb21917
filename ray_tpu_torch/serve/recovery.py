"""Serve in-flight request recovery: the journal + resume plane (the
colocated half of ``ray_tpu/serve/recovery.py``).

A replica death must not cost the caller their request. Every streaming
request dispatched through the ingress router is journaled: its
*immutable submission* (the payload: prompt token ids, sampling knobs,
max_tokens), the tenant, the request's context, and the items already
streamed to the caller. When the serving replica process dies mid-flight
(:class:`~ray_tpu_torch.exceptions.ActorDiedError` out of the stream),
the journal decides the recovery:

* **queued or prefilling** (zero items streamed): the submission is
  resubmitted to a live replica — nothing was delivered, so the retry is
  invisible (``cause="resubmit"``).
* **mid-decode** (tokens already streamed): the request is rebuilt as
  ``prompt + already-emitted tokens`` with the remaining token budget
  and replayed as a fresh prefill on a live replica (``cause="resume"``).
  Under greedy decoding the next token is a pure function of the context,
  so the resumed stream continues with the uninterrupted run's tokens
  (exactly in fp32; in bf16 a longer re-prefill sums in another order and
  may part at a near-tie). A *sampled* request re-seeds at the resume
  point, surfaced to the client by the ``x-ray-tpu-resumed`` marker.
* **draining replica** (clean reject at dispatch,
  ``ReplicaDrainingError``): re-routed to another replica without
  consuming the resume budget — the replica did no work.

Budget: ``RAY_TPU_SERVE_MAX_RESUMES`` (default 2) death recoveries per
request; exhaustion raises the typed
:class:`~ray_tpu_torch.exceptions.ResumeExhaustedError`.

The JAX package also records each recovery as a flight event and in the
serve metrics; in the port they wait for ROADMAP item 9, and recoveries
are logged. ``DisaggRecoverableStream`` (the prefill/decode split) waits
for item 6c.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions

logger = logging.getLogger(__name__)

#: Stream/header marker a client sees when a SAMPLED request was resumed
#: mid-decode (its continuation re-seeded — not the draw the dead
#: replica would have produced). Greedy resumes carry no marker.
RESUMED_MARKER = "x-ray-tpu-resumed"

#: Sentinel from :meth:`RequestJournal.resume_payload`: every requested
#: token was already delivered before the death — the stream is complete,
#: nothing to resume.
COMPLETE = object()

#: Drain rejects a single request tolerates before giving up — rejects
#: are free (the replica did no work) but must be bounded so a
#: deployment whose every replica is draining cannot spin a dispatch
#: loop forever. Shared by the streaming journal and the unary path in
#: ``serve/api.py``.
DRAIN_REJECT_CAP = 16


def max_resumes() -> int:
    """Per-request death-recovery budget (``RAY_TPU_SERVE_MAX_RESUMES``,
    read per decision so tests/operators retune live)."""
    return int(os.environ.get("RAY_TPU_SERVE_MAX_RESUMES", "2"))


def exhausted_error(deployment: str,
                    resumes: int) -> exceptions.ResumeExhaustedError:
    """The one typed terminal error both dispatch paths raise when the
    resume budget runs out."""
    return exceptions.ResumeExhaustedError(
        f"replica serving {deployment!r} died and the resume budget "
        f"(RAY_TPU_SERVE_MAX_RESUMES={max_resumes()}) is spent",
        resumes=resumes)


def is_llm_payload(payload: Any) -> bool:
    """True for the LLM completion payload shape (``prompt_token_ids``)
    whose streams are token-id items — the only shape resumable
    *mid-stream* (the emitted tokens extend the prompt)."""
    return (isinstance(payload, dict)
            and isinstance(payload.get("prompt_token_ids"), (list, tuple)))


def is_sampled(payload: Any) -> bool:
    """True when the request explicitly asks for sampled decoding —
    the case whose mid-decode resume re-seeds (and gets the
    ``x-ray-tpu-resumed`` marker). Engine-default decoding is greedy
    argmax, so an unannotated payload counts as greedy."""
    if not isinstance(payload, dict):
        return False
    try:
        if float(payload.get("temperature") or 0.0) > 0.0:
            return True
    except (TypeError, ValueError):
        return True  # unparseable knob: assume sampled (be honest)
    s = payload.get("sampling")
    if isinstance(s, dict):
        try:
            return float(s.get("temperature") or 0.0) > 0.0
        except (TypeError, ValueError):
            return True
    return False


class RequestJournal:
    """The immutable submission + delivery ledger of ONE streaming
    request. The payload is never mutated; resume payloads are derived
    copies. ``emitted`` holds exactly the items the consumer has been
    handed (recorded *after* a successful pull, so an item lost in
    flight is replayed, never skipped)."""

    def __init__(self, deployment: str, method: Optional[str],
                 payload: Any, model_id: str = "",
                 request_ctx: Optional[Dict[str, Any]] = None):
        self.deployment = deployment
        self.method = method
        self.payload = payload
        self.model_id = model_id
        # The SAME request context rides every attempt.
        self.request_ctx = request_ctx
        self.emitted: List[Any] = []
        self.resumes = 0          # death recoveries (budgeted)
        self.drain_rejects = 0    # clean re-routes (not budgeted)
        self.resumed_midstream = False
        # One ledger entry per KV handoff committed on this request's
        # behalf (crc32, bytes, attempt): the prefill/decode split's
        # exactly-once billing (``kv_transfer.transfer_inproc`` notes it).
        self.handoffs: List[Dict[str, Any]] = []

    @property
    def llm(self) -> bool:
        return is_llm_payload(self.payload)

    @property
    def sampled(self) -> bool:
        return is_sampled(self.payload)

    @property
    def needs_marker(self) -> bool:
        """The client must be told: a sampled request was resumed
        mid-decode, so its continuation is a re-seeded draw."""
        return self.resumed_midstream and self.sampled

    def record(self, item: Any) -> None:
        self.emitted.append(item)

    def note_handoff(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """Journal one prefill→decode KV handoff — idempotent PER
        ATTEMPT, so a retried bookkeeping call cannot double-bill the
        transfer. The entry is the manifest's billing-relevant core:
        crc32, byte/block counts, and the attempt that shipped it."""
        attempt = int(meta.get("attempt", self.resumes))
        for entry in self.handoffs:
            if entry.get("attempt") == attempt:
                return entry
        entry = {**meta, "attempt": attempt}
        self.handoffs.append(entry)
        return entry

    def resume_payload(self) -> Any:
        """The next attempt's submission, derived from the journal:

        * nothing emitted -> the original payload (plain resubmission);
        * mid-stream LLM request -> prompt extended by the emitted
          tokens, ``max_tokens`` reduced by them (:data:`COMPLETE` when
          zero remain);
        * mid-stream non-LLM request -> ``None`` (items already reached
          the caller and the stream has no replay semantics — not
          resumable)."""
        if not self.emitted:
            return self.payload
        if not self.llm:
            return None
        toks: List[int] = []
        for it in self.emitted:
            if isinstance(it, bool) or not isinstance(it, int):
                return None  # non-token items: no replay semantics
            toks.append(int(it))
        try:
            budget = int(self.payload.get("max_tokens", 16))
        except (TypeError, ValueError):
            return None
        remaining = budget - len(toks)
        if remaining <= 0:
            return COMPLETE
        ids = list(self.payload["prompt_token_ids"]) + toks
        # resumed_tokens marks a mid-decode REPLAY: the deployment honors
        # an EOS that was already streamed instead of decoding past it.
        return {**self.payload, "prompt_token_ids": ids,
                "max_tokens": remaining, "resumed_tokens": len(toks)}


class RecoverableStream:
    """Iterator over a streaming deployment call that survives replica
    death and drain. Every pull that raises ``ActorDiedError`` goes
    through the journal (resubmit / resume / typed exhaustion), and a
    ``ReplicaDrainingError`` reject re-routes to a live replica for free.
    :meth:`close` abandons the stream (the replica cancels the request)."""

    def __init__(self, handle, journal: RequestJournal,
                 per_item_timeout_s: Optional[float] = 60.0):
        self._handle = handle
        self.journal = journal
        self._timeout = per_item_timeout_s
        self._inner = None
        self._replica = None

    def __iter__(self) -> "RecoverableStream":
        return self

    def _dispatch(self, payload: Any) -> None:
        from ray_tpu_torch.serve.proxy import prefix_fingerprint

        j = self.journal
        # The attempt counter is stamped into the context, so the
        # replicas' request records tell the attempts apart.
        rctx = j.request_ctx
        if rctx is not None and (j.resumes or j.drain_rejects):
            rctx = {**rctx, "attempt": j.resumes + j.drain_rejects}
        # The prefix key is recomputed from the attempt's payload: after
        # an eviction the rendezvous ring has one fewer replica.
        h = self._handle.options(
            j.method, stream=True, multiplexed_model_id=j.model_id,
            request_context=rctx, prefix_key=prefix_fingerprint(payload))
        gen = h.remote(payload)
        gen._timeout = self._timeout
        self._replica = gen._replica
        self._inner = gen

    def _evict(self) -> None:
        if self._replica is not None:
            self._handle._evict(self._replica)
            self._replica = None

    def _reroute_drained(self) -> None:
        """The chosen replica is draining (clean reject — it did no
        work): evict it locally and redispatch the same submission,
        bounded by DRAIN_REJECT_CAP."""
        j = self.journal
        j.drain_rejects += 1
        if j.drain_rejects > DRAIN_REJECT_CAP:
            raise exceptions.ReplicaDrainingError(
                f"every replica of {j.deployment!r} rejected the request "
                f"as draining ({j.drain_rejects} rejects)")
        self._evict()
        self._dispatch(j.resume_payload() if j.emitted else j.payload)

    def _resume_after_death(self, err: BaseException) -> None:
        j = self.journal
        self._evict()
        payload = j.resume_payload()
        if payload is None:
            # Items already reached the caller and the stream has no
            # replay semantics: surface the death honestly.
            raise err
        if payload is COMPLETE:
            # Every requested token was delivered before the death: the
            # stream is COMPLETE (only the end-of-stream was lost) — no
            # budget consumed.
            self._inner = iter(())
            return
        if j.resumes >= max_resumes():
            raise exhausted_error(j.deployment, j.resumes) from err
        cause = "resume" if j.emitted else "resubmit"
        j.resumes += 1
        if j.emitted:
            j.resumed_midstream = True
        logger.warning(
            "serve: %s request to %r after replica death "
            "(%d item(s) already streamed, attempt %d/%d)",
            cause, j.deployment, len(j.emitted), j.resumes, max_resumes())
        self._dispatch(payload)

    def __next__(self) -> Any:
        j = self.journal
        if self._inner is None:
            self._dispatch(j.payload)
        while True:
            try:
                item = next(self._inner)
            except exceptions.ReplicaDrainingError:
                self._reroute_drained()
                continue
            except exceptions.ActorDiedError as e:
                self._resume_after_death(e)
                continue
            j.record(item)
            return item

    def close(self) -> None:
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


def note_unary_resumed(deployment: str, tenant: str) -> None:
    """A unary call completed after >= 1 death retry (the metrics wait
    for item 9; logged)."""
    logger.info("serve: unary call to %r (tenant %r) completed after a "
                "replica death", deployment, tenant)


def note_unary_exhausted(deployment: str, tenant: str) -> None:
    logger.warning("serve: unary call to %r (tenant %r) spent its resume "
                   "budget", deployment, tenant)


def note_unary_retry(deployment: str, cause: str) -> None:
    logger.warning("serve: unary call to %r retried (%s)", deployment,
                   cause)


__all__ = ["COMPLETE", "DRAIN_REJECT_CAP", "RESUMED_MARKER",
           "RecoverableStream", "RequestJournal", "exhausted_error",
           "is_llm_payload", "is_sampled", "max_resumes",
           "note_unary_exhausted", "note_unary_resumed",
           "note_unary_retry"]
