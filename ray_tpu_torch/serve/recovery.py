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
:class:`~ray_tpu_torch.exceptions.ResumeExhaustedError` and tags the
request ``resume_exhausted`` in ``ray_tpu_serve_request_outcomes_total``.
A stream that completes after >= 1 recovery is tagged ``resumed``.

:class:`DisaggRecoverableStream` is the same journal over a (prefill,
decode) role group: the KV handoff between them is journaled exactly
once per attempt, a prefill death resubmits and a decode death after
the handoff resumes as a fresh prefill.

Each recovery is a ``serve.resume`` flight event whose cause is the
drain or chaos firing that forced it (inferred from the flight ring, as
in JAX), counted in ``SERVE_REPLICA_RESUMES`` by cause; under tracing a
zero-length ``serve.resume`` span marks the point in the request's
trace. The split's outcomes go to ``SERVE_HANDOFFS`` and, as before, to
the journal's own ``handoff_outcomes``.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import metrics_defs as mdefs
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


def _flight_resume(j: "RequestJournal", mode: str) -> str:
    """The flight record of one stream re-route or resume. The request id
    comes from the trace context when present; otherwise one is minted at
    the first recovery and kept on the journal, so every recovery of the
    request chains under one subject. The cause is inferred from the
    ring: the deployment's newest drain, else the newest drain or chaos
    firing anywhere (a replica's firings reach this process's ring over
    its pipe)."""
    rid = (j.request_ctx or {}).get("request_id", "")
    if not rid:
        rid = getattr(j, "flight_request_id", "")
        if not rid:
            rid = j.flight_request_id = tracing.gen_id()
    cause = _events.latest_event_id(
        ["serve.drain_begin"], subject={"deployment": j.deployment}) or \
        _events.latest_event_id(["serve.drain_begin", "chaos.inject"])
    return _events.emit(
        "serve.resume", cause=cause,
        subject={"deployment": j.deployment, "request_id": rid},
        mode=mode, emitted=len(j.emitted), attempt=j.resumes)

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
        # The split's outcomes (ok, prefill_died, decode_died) for this
        # request; SERVE_HANDOFFS counts them over requests.
        self.handoff_outcomes: Dict[str, int] = {}

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

    def count_handoff(self, outcome: str) -> None:
        self.handoff_outcomes[outcome] = \
            self.handoff_outcomes.get(outcome, 0) + 1
        mdefs.SERVE_HANDOFFS.inc(tags={"deployment": self.deployment,
                                       "outcome": outcome})

    def tags(self, engine: str = "router") -> Dict[str, str]:
        return {"deployment": self.deployment, "tenant": self.model_id,
                "engine": engine}

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
        self._completion_reported = False

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

    def _death_cause(self) -> str:
        return "resume" if self.journal.emitted else "resubmit"

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
        mdefs.SERVE_REPLICA_RESUMES.inc(tags={
            "deployment": j.deployment, "cause": "drain_reject"})
        _flight_resume(j, "drain_reject")
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
            mdefs.SERVE_REQ_OUTCOMES.inc(tags={
                **j.tags(), "outcome": "resume_exhausted"})
            raise exhausted_error(j.deployment, j.resumes) from err
        cause = self._death_cause()
        j.resumes += 1
        if j.emitted:
            j.resumed_midstream = True
        mdefs.SERVE_REPLICA_RESUMES.inc(tags={
            "deployment": j.deployment, "cause": cause})
        _flight_resume(j, cause)
        rctx = j.request_ctx or {}
        if rctx and tracing.enabled():
            # A zero-length marker in the request's trace: the recovery
            # point between the two replicas' engine spans.
            tracing.emit_span(
                "serve.resume", trace_id=rctx.get("trace_id", ""),
                parent_span_id=rctx.get("parent_span_id", ""),
                ts=time.time(), dur=0.0, kind="route",
                request_id=rctx.get("request_id", ""),
                deployment=j.deployment, cause=cause,
                emitted=len(j.emitted), attempt=j.resumes)
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
            except StopIteration:
                if j.resumes and not self._completion_reported:
                    self._completion_reported = True
                    mdefs.SERVE_REQ_OUTCOMES.inc(tags={
                        **j.tags(), "outcome": "resumed"})
                raise
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


class DisaggRecoverableStream(RecoverableStream):
    """Recoverable stream over a (prefill, decode) role-group pair, the
    split twin of :class:`RecoverableStream`. Dispatch is staged: reserve
    the decode slot, run the unary ``prefill`` on the prefill group (it
    returns the KV handoff's manifest; the staging bytes wait in the shm
    channel it names), journal the handoff, then open the
    ``decode_from`` stream on the decode group. Every token, the
    prefill's first one included, reaches the caller through the decode
    stream, so the journal's ``emitted`` stays the one ledger of what
    was delivered.

    A death on either side lands in the same journal:

    * **prefill death** (unary: nothing delivered, nothing journaled):
      the submission resubmits to another prefill replica
      (``cause="resubmit"``, budgeted like any death retry);
    * **decode death after the handoff**: a replay from the journal as
      a fresh prefill (``cause="resume"``: the first token crossed
      replicas, so it is visible state even with nothing delivered).
      The replay journals a new attempt's entry, and
      :meth:`RequestJournal.note_handoff` refuses a second entry for the
      same attempt, so a request is never billed twice.

    The decode slot's reservation is cancelled on every path that does
    not spend it (a prefill that finished the request, a spent budget,
    an abandoned stream)."""

    def __init__(self, prefill_handle, decode_handle,
                 journal: RequestJournal,
                 per_item_timeout_s: Optional[float] = 60.0):
        super().__init__(decode_handle, journal, per_item_timeout_s)
        self._prefill_handle = prefill_handle
        # True between note_handoff and the stream's end: a death in
        # that window is a decode death after the handoff.
        self._handoff_live = False
        # (ticket, the decode replica holding it) until spent or freed.
        self._reservation = None

    def _death_cause(self) -> str:
        return ("resume" if (self.journal.emitted or self._handoff_live)
                else "resubmit")

    def _resume_after_death(self, err: BaseException) -> None:
        j = self.journal
        handoff_was_live = self._handoff_live
        if handoff_was_live:
            j.count_handoff("decode_died")
        pre = j.resumes
        super()._resume_after_death(err)
        if handoff_was_live and j.resumes > pre:
            # The first token crossed replicas: even with nothing
            # delivered the replay is visible, so a sampled request
            # carries the resumed marker.
            j.resumed_midstream = True

    # ---------------------------------------------------------- dispatch
    def _cancel_reservation(self) -> None:
        """Release the unspent ticket on the replica that holds it (a
        dead replica's went with it; tickets also expire engine-side)."""
        held, self._reservation = self._reservation, None
        if held is None or held[0] is None:
            return
        ticket, replica = held
        try:
            replica.call("cancel_reserve", (ticket,), {}).result(timeout=5)
        except Exception:  # noqa: BLE001 — expires engine-side anyway
            logger.info("serve: a decode reservation's cancel failed")

    def _reserve(self, payload: Any, fp: str) -> None:
        """Reserve the decode slot before any prefill work (advisory: a
        miss means the import allocates on arrival; the ticket carries
        its replica's nonce, so another replica refuses it)."""
        j = self.journal
        prompt = (payload.get("prompt_token_ids") or ()
                  if isinstance(payload, dict) else ())
        try:
            budget = int(payload.get("max_tokens", 16)) \
                if isinstance(payload, dict) else 16
        except (TypeError, ValueError):
            budget = 16
        self._cancel_reservation()
        try:
            resp = self._handle.options(
                "reserve_kv", multiplexed_model_id=j.model_id,
                prefix_key=fp).remote(len(prompt), budget)
            self._reservation = (resp.result(timeout_s=5), resp._replica)
        except Exception:  # noqa: BLE001 — the reservation is advisory
            self._reservation = None

    def _prefill_attempt(self, payload: Any, rctx, fp: str):
        """One journaled prefill attempt: the manifest, or None when the
        chosen prefill replica died or drained (the journal advanced and
        the caller retries)."""
        j = self.journal
        h = self._prefill_handle.options(
            "prefill", multiplexed_model_id=j.model_id,
            request_context=rctx, prefix_key=fp)
        resp = h.remote(payload)
        try:
            # The response's own death retry is bypassed: a prefill death
            # is this journal's to budget.
            return resp._future.result(timeout=self._timeout)
        except exceptions.ReplicaDrainingError:
            # Clean reject: a free reroute, bounded by the shared cap.
            j.drain_rejects += 1
            if j.drain_rejects > DRAIN_REJECT_CAP:
                raise exceptions.ReplicaDrainingError(
                    f"every prefill replica of {j.deployment!r} rejected "
                    f"the request as draining ({j.drain_rejects} rejects)")
            self._prefill_handle._evict(resp._replica)
            mdefs.SERVE_REPLICA_RESUMES.inc(tags={
                "deployment": j.deployment, "cause": "drain_reject"})
            _flight_resume(j, "drain_reject")
            return None
        except exceptions.ActorDiedError as e:
            # Nothing reached the caller and nothing was journaled: the
            # submission resubmits to another prefill replica, budgeted.
            self._prefill_handle._evict(resp._replica)
            j.count_handoff("prefill_died")
            if j.resumes >= max_resumes():
                mdefs.SERVE_REQ_OUTCOMES.inc(tags={
                    **j.tags(), "outcome": "resume_exhausted"})
                raise exhausted_error(j.deployment, j.resumes) from e
            j.resumes += 1
            mdefs.SERVE_REPLICA_RESUMES.inc(tags={
                "deployment": j.deployment, "cause": "resubmit"})
            _flight_resume(j, "resubmit")
            logger.warning(
                "serve: resubmitting prefill for %r after replica death "
                "(attempt %d/%d)", j.deployment, j.resumes, max_resumes())
            return None

    def _dispatch(self, payload: Any) -> None:
        from ray_tpu_torch.serve.proxy import prefix_fingerprint

        j = self.journal
        self._handoff_live = False
        fp = prefix_fingerprint(payload)
        # (1) Reserve the decode slot before any prefill work.
        self._reserve(payload, fp)
        # (2) Prefill, a journaled unary retry loop.
        try:
            while True:
                rctx = j.request_ctx
                if rctx is not None and (j.resumes or j.drain_rejects):
                    rctx = {**rctx, "attempt": j.resumes + j.drain_rejects}
                manifest = self._prefill_attempt(payload, rctx, fp)
                if manifest is not None:
                    break
        except BaseException:
            self._cancel_reservation()
            raise
        if isinstance(manifest, dict) and "done" in manifest:
            # The request finished at prefill (max_tokens 1, EOS first,
            # or a resumed prompt already ending in EOS): nothing to hand
            # off; its tokens stream out and are journaled as any items.
            self._cancel_reservation()
            self._replica = None
            self._inner = iter(list(manifest["done"]))
            return
        # (3) Journal the handoff before the decode side can touch it:
        # only a stamped manifest imports, so a request is never billed
        # for an unjournaled transfer.
        j.note_handoff({
            "crc32": manifest.get("crc32"),
            "nbytes": manifest.get("nbytes"),
            "num_blocks": manifest.get("num_blocks"),
            "attempt": j.resumes,
        })
        manifest = {**manifest, "journaled": True}
        self._handoff_live = True
        # (4) The decode stream: every token, the first included. A
        # ticket of another replica than the stream's is released.
        dh = self._handle.options(
            "decode_from", stream=True, multiplexed_model_id=j.model_id,
            request_context=rctx, prefix_key=fp)
        ticket = self._reservation[0] if self._reservation else None
        gen = dh.remote({"manifest": manifest, "reservation": ticket})
        gen._timeout = self._timeout
        if self._reservation is not None and \
                self._reservation[1] is gen._replica:
            self._reservation = None          # spent by the import
        self._cancel_reservation()
        self._replica = gen._replica
        self._inner = gen
        j.count_handoff("ok")

    def close(self) -> None:
        self._cancel_reservation()
        super().close()


def note_unary_resumed(deployment: str, tenant: str) -> None:
    """Metrics for a unary call that completed after >= 1 death retry
    (the ``serve/api.py`` unary journal path)."""
    mdefs.SERVE_REQ_OUTCOMES.inc(tags={
        "deployment": deployment, "tenant": tenant, "engine": "router",
        "outcome": "resumed"})


def note_unary_exhausted(deployment: str, tenant: str) -> None:
    mdefs.SERVE_REQ_OUTCOMES.inc(tags={
        "deployment": deployment, "tenant": tenant, "engine": "router",
        "outcome": "resume_exhausted"})


def note_unary_retry(deployment: str, cause: str) -> None:
    mdefs.SERVE_REPLICA_RESUMES.inc(tags={
        "deployment": deployment, "cause": cause})
    logger.warning("serve: unary call to %r retried (%s)", deployment,
                   cause)


__all__ = ["COMPLETE", "DRAIN_REJECT_CAP", "DisaggRecoverableStream",
           "RESUMED_MARKER", "RecoverableStream", "RequestJournal", "exhausted_error",
           "is_llm_payload", "is_sampled", "max_resumes",
           "note_unary_exhausted", "note_unary_resumed",
           "note_unary_retry"]
