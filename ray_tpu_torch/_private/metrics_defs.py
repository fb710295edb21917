"""The port's metric catalog (the counterpart of
``ray_tpu/_private/metrics_defs.py``): only the series the port emits.

Each keeps the JAX package's name, kind, description, tag keys and
histogram boundaries (``tests/test_torch_metrics.py`` holds them to
JAX's), so a dashboard or a query written against one package reads the
other. The profiling plane's ``XLA_*``, ``DEVICE_MEM_*`` and
``PROFILE_CAPTURES`` keep JAX's names and descriptions although the port
compiles no XLA program (:mod:`ray_tpu_torch._private.cuda_monitor`
counts a program's first call at each argument signature as its
compile). ``POOL_CHIPS`` keeps its name and counts cards (or fractions
of one, where replicas ask fractions). The series of modules not ported
yet stay out: the GCS, RPC, node and agent series, and of the store's
all but its two gauges.

Units follow Prometheus conventions: ``_total`` counters, ``_seconds`` /
``_bytes`` gauges and histograms.
"""

from __future__ import annotations

from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram


# ------------------------------------------------------ node store (L4)
# The node manager's shared-memory store, set each heartbeat
# (``_private/node_manager/server.py``).
STORE_USED_BYTES = Gauge(
    "ray_tpu_store_used_bytes",
    "Bytes resident in the node shared-memory store",
    ("node_id",))
STORE_OBJECTS = Gauge(
    "ray_tpu_store_objects",
    "Objects resident in the node shared-memory store",
    ("node_id",))

# ----------------------------------------------------------- serve (L6)
# The router's series (``serve/api.py``).
SERVE_REQUESTS = Counter(
    "ray_tpu_serve_requests_total",
    "Requests routed per deployment (streaming included)",
    ("deployment",))
SERVE_LATENCY = Histogram(
    "ray_tpu_serve_request_latency_seconds",
    "End-to-end deployment request latency seen by the router",
    tag_keys=("deployment",))
SERVE_QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_queue_depth",
    "In-flight requests this router currently has against a deployment",
    ("deployment",))
SERVE_ROUTER_AFFINITY = Counter(
    "ray_tpu_serve_router_affinity_total",
    "Prefix-affinity routing decisions: affinity (request landed on its "
    "fingerprint's home replica), overflow (home too pressured — spilled "
    "to the second rendezvous choice)",
    ("deployment", "decision"))

# ----------------------------------------- serve replica lifecycle (L6)
# The serve failure plane: controller-initiated drains, observed replica
# deaths, and in-flight request resumes (``runtime/controller.py``,
# ``serve/recovery.py``).
SERVE_REPLICA_DRAINS = Counter(
    "ray_tpu_serve_replica_drains_total",
    "Controller-initiated replica drains by cause (scale_down/preemption/"
    "delete) — a draining replica stops admitting, leaves the routing "
    "ring, finishes in-flight requests up to RAY_TPU_SERVE_DRAIN_S, then "
    "tears down",
    ("deployment", "cause"))
SERVE_REPLICA_DEATHS = Counter(
    "ray_tpu_serve_replica_deaths_total",
    "Replica deaths observed by the controller/router by cause "
    "(died: health probe found it dead; drain: it died while draining)",
    ("deployment", "cause"))
SERVE_REPLICA_RESUMES = Counter(
    "ray_tpu_serve_replica_resumes_total",
    "In-flight requests recovered after replica death, by cause: "
    "resubmit (queued/prefilling — no tokens lost), resume (mid-decode — "
    "prompt + emitted tokens replayed as a new prefill; exactly-once "
    "under greedy decoding), drain_reject (clean re-route off a draining "
    "replica, no budget consumed)",
    ("deployment", "cause"))
SERVE_DRAIN_SECONDS = Histogram(
    "ray_tpu_serve_drain_seconds",
    "Drain initiation to teardown per drained replica, by outcome "
    "(drained: in-flight work finished; deadline: RAY_TPU_SERVE_DRAIN_S "
    "expired with requests still running; died: replica died while "
    "draining)",
    boundaries=(0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                300.0),
    tag_keys=("deployment", "outcome"))

# ----------------------------------------- serve pressure autoscaling (L6)
SERVE_AUTOSCALE_DECISIONS = Counter(
    "ray_tpu_serve_autoscale_decisions_total",
    "Serve autoscaler scale intents applied, by direction (up/down) and "
    "the dominant signal that drove them (ongoing: router in-flight vs "
    "target_ongoing_requests; queue: engine queue depth vs "
    "target_queue_depth; kv: paged-KV arena starvation; shed: ingress "
    "shed rate observed since the last decision)",
    ("deployment", "direction", "signal"))

# ------------------------------------- serve request path (L6 + engine)
# Per-request latency attribution emitted by the continuous-batching
# engine at request lifecycle boundaries: TTFT decomposes into
# queue + arena-wait + prefill, and TPOT is the steady decode cadence
# after the first token. Tagged per deployment and per tenant (the
# multiplexed model id); ``role`` carries the engine's disaggregation
# role (prefill/decode/both).
_REQ_TAGS = ("deployment", "tenant", "engine", "role")
SERVE_REQ_TTFT = Histogram(
    "ray_tpu_serve_request_ttft_seconds",
    "Time to first token: engine submit to first-token fetch "
    "(= queue + arena_wait + prefill)",
    boundaries=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0, 60.0),
    tag_keys=_REQ_TAGS)
SERVE_REQ_QUEUE = Histogram(
    "ray_tpu_serve_request_queue_seconds",
    "TTFT component: submit to admission pickup (waiting for a free "
    "KV slot / the admission loop)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    tag_keys=_REQ_TAGS)
SERVE_REQ_ARENA_WAIT = Histogram(
    "ray_tpu_serve_request_arena_wait_seconds",
    "TTFT component: time the request sat at the head of the admission "
    "queue blocked on free paged-KV arena blocks (0 when never blocked)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    tag_keys=_REQ_TAGS)
SERVE_REQ_PREFILL = Histogram(
    "ray_tpu_serve_request_prefill_seconds",
    "TTFT component: prefill dispatch to first-token fetch for the "
    "request's admission batch",
    boundaries=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0),
    tag_keys=_REQ_TAGS)
SERVE_REQ_TPOT = Histogram(
    "ray_tpu_serve_request_tpot_seconds",
    "Time per output token after the first (first token to finish over "
    "generated-token count): the steady decode cadence one request saw",
    boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0),
    tag_keys=_REQ_TAGS)
SERVE_REQ_OUTCOMES = Counter(
    "ray_tpu_serve_request_outcomes_total",
    "Engine request terminations by outcome "
    "(finished/evicted/aborted/prefilled — prefilled is a prefill-role "
    "engine parking the request for KV handoff at its first token)",
    _REQ_TAGS + ("outcome",))

# ---------------------------- disaggregated prefill/decode handoff (L6)
# Observed in ``serve/kv_transfer.py``. ``direction`` partitions the
# handoff wall into its three legs: export (arena gather -> host
# staging), channel (shm channel write and read), import (crc verify +
# arena scatter + radix insert).
_KV_TRANSFER_TAGS = ("deployment", "direction")
SERVE_KV_TRANSFER_SECONDS = Histogram(
    "ray_tpu_serve_kv_transfer_seconds",
    "KV handoff leg wall time, by direction (export/channel/import)",
    boundaries=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0),
    tag_keys=_KV_TRANSFER_TAGS)
SERVE_KV_TRANSFER_BYTES = Counter(
    "ray_tpu_serve_kv_transfer_bytes_total",
    "Staging-buffer bytes moved by KV handoffs, by direction",
    _KV_TRANSFER_TAGS)
SERVE_KV_TRANSFER_BLOCKS = Counter(
    "ray_tpu_serve_kv_transfer_blocks_total",
    "Arena blocks moved by KV handoffs, by direction",
    _KV_TRANSFER_TAGS)
SERVE_HANDOFFS = Counter(
    "ray_tpu_serve_handoff_total",
    "Prefill->decode handoffs by outcome (ok: imported and streaming; "
    "prefill_died: death before the manifest — resubmitted, cause="
    "resubmit; decode_died: death after the journaled handoff — "
    "replayed as a fresh prefill, cause=resume; crc_mismatch: payload "
    "failed verification on import)",
    ("deployment", "outcome"))

# ---------------------------------------------- event/span buffer drops
EVENTS_DROPPED = Counter(
    "ray_tpu_events_dropped_total",
    "Task-event/span records shed by a full buffer, by buffer "
    "(timeline ring, per-channel BufferedPublisher, flight ring, GCS "
    "flight store) — a non-zero rate means traces/chains have holes",
    ("buffer",))
EVENTS_TOTAL = Counter(
    "ray_tpu_events_total",
    "Flight-recorder control-plane events emitted, by event type "
    "(lease transitions, drains, preemption notices, recoveries, chaos "
    "injections...); loss is counted in ray_tpu_events_dropped_total",
    ("type",))

# --------------------------------------- continuous batching / LLM (L6)
CB_SLOT_OCCUPANCY = Gauge(
    "ray_tpu_cb_slot_occupancy",
    "Fraction of KV-cache slots active in the continuous-batching engine",
    ("engine",))
CB_ACTIVE_SLOTS = Gauge(
    "ray_tpu_cb_active_slots",
    "KV-cache slots currently decoding",
    ("engine",))
CB_WAITING_REQUESTS = Gauge(
    "ray_tpu_cb_waiting_requests",
    "Requests admitted but waiting for a free KV slot",
    ("engine",))
CB_DECODE_TOKENS = Counter(
    "ray_tpu_cb_decode_tokens_total",
    "Tokens produced by the continuous-batching decode loop",
    ("engine",))
CB_TICK_MS = Histogram(
    "ray_tpu_cb_tick_ms",
    "Wall milliseconds per decode tick (dispatch+compute+fetch with "
    "per-tick sync; dispatch only when speculative buffering overlaps "
    "the fetch)",
    boundaries=(0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                500.0, 1000.0),
    tag_keys=("engine",))
CB_PREFILL_REQUESTS = Counter(
    "ray_tpu_cb_prefill_requests_total",
    "Requests admitted into KV slots via (batched bucketed) prefill",
    ("engine",))
CB_PREFILL_TOKENS = Counter(
    "ray_tpu_cb_prefill_tokens_total",
    "Prompt tokens prefilled (true lengths; bucket padding excluded)",
    ("engine",))
CB_KV_BLOCKS_USED = Gauge(
    "ray_tpu_cb_kv_blocks_used",
    "Paged-KV arena blocks currently reserved by active slots",
    ("engine",))
CB_KV_BLOCKS_TOTAL = Gauge(
    "ray_tpu_cb_kv_blocks_total",
    "Paged-KV arena capacity in blocks (garbage block excluded)",
    ("engine",))
CB_KV_FRAG_RATIO = Gauge(
    "ray_tpu_cb_kv_frag_ratio",
    "Reserved-but-unwritten fraction of used paged-KV blocks "
    "(internal fragmentation of the arena)",
    ("engine",))
CB_PREFIX_HIT_TOKENS = Counter(
    "ray_tpu_cb_prefix_hit_tokens_total",
    "Prompt tokens served from cached prefix blocks instead of being "
    "prefilled (radix prefix cache hits, block-aligned)",
    ("engine",))
CB_PREFIX_MISS_TOKENS = Counter(
    "ray_tpu_cb_prefix_miss_tokens_total",
    "Prompt tokens actually prefilled (novel suffixes; the whole prompt "
    "on a cold miss) — hit/(hit+miss) is the prefix hit rate",
    ("engine",))
CB_KV_BLOCKS_CACHED = Gauge(
    "ray_tpu_cb_kv_blocks_cached",
    "Refcount-0 prefix blocks parked in the radix LRU: revivable by a "
    "prefix match, reclaimed before admission blocks on the arena",
    ("engine",))
CB_KV_BLOCKS_SHARED = Gauge(
    "ray_tpu_cb_kv_blocks_shared",
    "Indexed prefix blocks pinned (refcounted) by at least one live "
    "slot — never reclaimed while referenced",
    ("engine",))
CB_SPEC_DRAFT_TOKENS = Counter(
    "ray_tpu_cb_spec_draft_tokens_total",
    "Tokens proposed by the speculative-decode drafter (k per slot per "
    "spec tick); with accepted_tokens this prices how much verify "
    "bandwidth the drafts are buying",
    ("engine",))
CB_SPEC_ACCEPTED_TOKENS = Counter(
    "ray_tpu_cb_spec_accepted_tokens_total",
    "Drafted tokens the batched verify pass accepted (committed beyond "
    "the one token a plain tick would have produced)",
    ("engine",))
CB_SPEC_ACCEPT_RATE = Gauge(
    "ray_tpu_cb_spec_accept_rate",
    "Windowed speculative-decode accept rate (accepted/drafted over the "
    "last RAY_TPU_SPEC_WINDOW spec ticks) — the controller input that "
    "moves spec_k along its rung ladder",
    ("engine",))
CB_SPEC_K = Gauge(
    "ray_tpu_cb_spec_k",
    "Live speculative draft depth k the engine is dispatching (0 = the "
    "controller parked on the plain tick; configured maximum is the "
    "spec_k knob)",
    ("engine",))

# ------------------------------------------ profiling plane (_private/
# cuda_monitor.py): compiles/retraces per instrumented program, counted
# cost, and achieved throughput against it.
XLA_COMPILES = Counter(
    "ray_tpu_xla_compiles_total",
    "XLA compilations of instrumented programs (one per new signature)",
    ("program",))
XLA_COMPILE_SECONDS = Histogram(
    "ray_tpu_xla_compile_seconds",
    "Wall time of one XLA compilation (lower + compile)",
    boundaries=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
    tag_keys=("program",))
XLA_RETRACES = Counter(
    "ray_tpu_xla_retraces_total",
    "Recompiles of an instrumented program for an UNEXPECTED new "
    "shape/dtype signature (bucketed growth is exempt); the offending "
    "signature diff is logged",
    ("program",))
XLA_PROGRAM_FLOPS = Gauge(
    "ray_tpu_xla_program_flops",
    "Compiler cost-analysis FLOPs per invocation of the latest "
    "compiled signature",
    ("program",))
XLA_PROGRAM_BYTES = Gauge(
    "ray_tpu_xla_program_bytes_accessed",
    "Compiler cost-analysis bytes accessed (HBM traffic) per invocation "
    "of the latest compiled signature",
    ("program",))
XLA_ACHIEVED_FLOPS = Gauge(
    "ray_tpu_xla_achieved_flops_per_s",
    "Achieved FLOP/s: cost-analysis FLOPs over measured step/tick wall "
    "time (no estimation)",
    ("program",))
XLA_ACHIEVED_BW = Gauge(
    "ray_tpu_xla_achieved_bandwidth_bytes_per_s",
    "Achieved memory bandwidth: cost-analysis bytes accessed over "
    "measured step/tick wall time",
    ("program",))
XLA_MFU = Gauge(
    "ray_tpu_xla_model_flops_utilization",
    "Achieved FLOP/s over the chip's peak (emitted only on known "
    "device kinds)",
    ("program",))

# --------------------------------------------- device memory vitals
DEVICE_MEM_USED = Gauge(
    "ray_tpu_device_mem_used_bytes",
    "Accelerator bytes_in_use from device memory_stats() (absent on "
    "backends without memory stats, e.g. CPU)",
    ("node_id", "device"))
DEVICE_MEM_PEAK = Gauge(
    "ray_tpu_device_mem_peak_bytes",
    "Accelerator peak_bytes_in_use from device memory_stats()",
    ("node_id", "device"))
DEVICE_MEM_LIMIT = Gauge(
    "ray_tpu_device_mem_limit_bytes",
    "Accelerator bytes_limit from device memory_stats()",
    ("node_id", "device"))

PROFILE_CAPTURES = Counter(
    "ray_tpu_profile_captures_total",
    "jax.profiler trace captures executed by this process, by outcome",
    ("status",))

# --------------------------------------- checkpoint plane (checkpoint/)
CKPT_BLOCK_MS = Histogram(
    "ray_tpu_ckpt_block_ms",
    "Milliseconds the step loop was blocked by a save (device→host "
    "snapshot only; serialization and the write run in the background)",
    boundaries=(1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0, 5000.0,
                30000.0),
    tag_keys=("run",))
CKPT_SAVE_SECONDS = Histogram(
    "ray_tpu_ckpt_save_seconds",
    "End-to-end wall time of one participant's checkpoint persist "
    "(snapshot through shard write and commit attempt)",
    boundaries=(0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
    tag_keys=("run",))
CKPT_RESTORE_SECONDS = Histogram(
    "ray_tpu_ckpt_restore_seconds",
    "Wall time of one elastic restore (manifest read, shard reassembly, "
    "re-shard device_put)",
    boundaries=(0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0),
    tag_keys=("run",))
CKPT_BYTES = Counter(
    "ray_tpu_ckpt_bytes_total",
    "Checkpoint bytes moved by this process, by direction (save/restore)",
    ("run", "direction"))
CKPT_SAVES = Counter(
    "ray_tpu_ckpt_saves_total",
    "Checkpoint persists by outcome: committed (this participant flipped "
    "the manifest), registered (a peer commits), failed",
    ("run", "outcome"))

CKPT_PREEMPT_NOTICES = Counter(
    "ray_tpu_ckpt_preempt_notices_total",
    "Preemption notices delivered to this process, by source "
    "(local/publish/pubsub)",
    ("source",))

# ---------------------------------------------------------------- train (L6)
# The trainer controller (``train/trainer.py``), its ingest prefetcher
# (``train/ingest.py``) and step loop (``train/loop.py``).
TRAIN_REPORTS = Counter(
    "ray_tpu_train_reports_total",
    "train.report() rounds merged by the trainer",
    ("trainer",))
TRAIN_STEP_SECONDS = Histogram(
    "ray_tpu_train_step_seconds",
    "Wall time between consecutive merged report rounds",
    tag_keys=("trainer",))
TRAIN_TOKENS_PER_S = Gauge(
    "ray_tpu_train_tokens_per_s",
    "Training throughput as last reported by rank 0 (tokens_per_s key)",
    ("trainer",))
TRAIN_RESTARTS = Counter(
    "ray_tpu_train_restarts_total",
    "Elastic trainer restarts by failure cause (worker_lost/hang/"
    "preemption/resize/user) — fatal errors end the run and are not "
    "counted",
    ("trainer", "cause"))
TRAIN_WORLD_SIZE = Gauge(
    "ray_tpu_train_world_size",
    "Worker count the current training attempt was scheduled with "
    "(moves on elastic shrink/grow restarts)",
    ("trainer",))
TRAIN_RECOVERY_SECONDS = Histogram(
    "ray_tpu_train_recovery_seconds",
    "Failure detection to the restarted attempt's first report: group "
    "teardown + backoff + re-acquisition + mesh re-formation + manifest "
    "restore + first step",
    boundaries=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 180.0, 600.0,
                1800.0),
    tag_keys=("trainer",))
TRAIN_GOODPUT_SECONDS = Counter(
    "ray_tpu_train_goodput_seconds_total",
    "Attempt wall clock attributed by the goodput ledger, by component: "
    "step (productive: dispatching / free-running ahead of the device), "
    "input_stall (empty prefetch buffer), sync (windowed metric fetch), "
    "ckpt_block (checkpoint device->host snapshot), recovery (elastic "
    "recovery dead time + restore) — rank-0 ledger deltas plus the "
    "controller's inter-session recovery time",
    ("trainer", "component"))
TRAIN_GOODPUT_FRACTION = Gauge(
    "ray_tpu_train_goodput_fraction",
    "Fraction of the current attempt's wall clock per goodput-ledger "
    "component (components sum to 1; the dashboard stacks them)",
    ("trainer", "component"))
TRAIN_RANK_STEP_SECONDS = Histogram(
    "ray_tpu_train_rank_step_seconds",
    "Per-rank step wall time (dispatch->report gap recorded by each "
    "worker's session) — the controller's window merge of these feeds "
    "rank-skew scoring and straggler detection",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0,
                120.0),
    tag_keys=("trainer", "rank"))
TRAIN_STRAGGLER = Gauge(
    "ray_tpu_train_straggler",
    "1 while a rank is flagged as a straggler (mean step time over "
    "RAY_TPU_STRAGGLER_FACTOR x the window median for "
    "RAY_TPU_STRAGGLER_WINDOWS consecutive windows), 0 once cleared",
    ("trainer", "rank"))
TRAIN_INPUT_STALL = Histogram(
    "ray_tpu_train_input_stall_seconds",
    "Per-batch time the train loop sat blocked on an empty device-"
    "prefetch buffer (the input pipeline couldn't keep up) — the "
    "histogram _sum over wall time is the run's input-stall fraction",
    boundaries=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                1.0, 5.0),
    tag_keys=("iterator",))
TRAIN_PREFETCH_OCCUPANCY = Gauge(
    "ray_tpu_train_prefetch_buffer_occupancy",
    "Device-prefetch buffer fill fraction (0 = consumer starved, "
    "1 = producer a full depth ahead) sampled at each put/get",
    ("iterator",))
TRAIN_INGEST_BYTES = Counter(
    "ray_tpu_train_ingest_bytes_total",
    "Host bytes staged onto the device mesh by the ingest prefetcher "
    "(decode output, pre-device_put) — its rate is the training "
    "data-plane bytes/s",
    ("iterator",))

# --------------------------------------------- RL weight-sync plane (rl/)
RL_SYNC_SECONDS = Histogram(
    "ray_tpu_rl_weight_sync_seconds",
    "Wall time of one weight-sync hop, by path (publish: trainer manifest "
    "build + checkpoint persist + channel write; subscribe: channel read + "
    "crc verify + reshard; fallback: checkpoint-plane restore when the "
    "fast path is unavailable)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    tag_keys=("run", "path"))
RL_SYNC_BYTES = Counter(
    "ray_tpu_rl_weight_sync_bytes_total",
    "Weight bytes moved by the sync plane, by path "
    "(publish/subscribe/fallback)",
    ("run", "path"))
RL_VERSION = Gauge(
    "ray_tpu_rl_weight_sync_version",
    "Latest weight version seen, by role (trainer: last published; "
    "generator: version live in the serving engine) — the trainer/"
    "generator gap is the sync lag in versions",
    ("run", "role"))
RL_ROLLOUT_STALENESS = Gauge(
    "ray_tpu_rl_rollout_staleness",
    "Worst sequence staleness (trainer version minus producing weight "
    "version) in the most recent generation phase",
    ("run",))
RL_SWAPS = Counter(
    "ray_tpu_rl_weight_swaps_total",
    "Generator weight swaps applied at a tick boundary, by cause "
    "(publish/fallback/restore)",
    ("run", "cause"))
RL_SYNC_SHED = Counter(
    "ray_tpu_rl_weight_sync_shed_total",
    "Published versions a lagging subscriber never acked before the "
    "writer overwrote them (shed-with-attribution: the subscriber tag "
    "names the laggard; it re-converges via the checkpoint fallback)",
    ("run", "subscriber"))

# --------------------------------------- chip pool arbiter (L7, arbiter.py)
# The serve<->train handoff plane (``autoscaler/arbiter.py``): every unit
# sits in exactly one ledger state (serve / train / in_flight), and every
# lease transition is journaled into the __pool__ KV.
POOL_CHIPS = Gauge(
    "ray_tpu_pool_chips",
    "Chips per ledger owner (serve / train / in_flight) — the three "
    "always sum to the pool total (the conservation invariant)",
    ("owner",))
POOL_LEASES = Gauge(
    "ray_tpu_pool_leases",
    "Live (non-terminal) chip leases by state-machine stage",
    ("stage",))
POOL_HANDOFFS = Counter(
    "ray_tpu_pool_handoffs_total",
    "Chip handoffs reaching a terminal disposition, by direction "
    "(serve_to_train/train_to_serve) and outcome (committed: recipient "
    "confirmed and the lease went live; returned: lease deadline lapsed "
    "or an SLO reversal gave the chips back; aborted: rolled back before "
    "commit)",
    ("direction", "outcome"))
POOL_HANDOFF_SECONDS = Histogram(
    "ray_tpu_pool_handoff_seconds",
    "Wall time from lease creation to COMMITTED (donor drain/shrink + "
    "recipient absorb + confirmation), by direction",
    boundaries=(0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
                1800.0),
    tag_keys=("direction",))
POOL_SLO_REVERSALS = Counter(
    "ray_tpu_pool_slo_reversals_total",
    "SLO-guard interventions: a planned take of serve chips refused "
    "(refused) or a committed serve->train lease reversed (reversed), "
    "by the breaching signal (shed_rate/ttft_p95/latency_p95)",
    ("action", "signal"))
POOL_INVARIANT_VIOLATIONS = Counter(
    "ray_tpu_pool_invariant_violations_total",
    "Chip-conservation invariant violations detected by the ledger "
    "verifier (a chip in two ledger states, or orphaned) — any nonzero "
    "value is a bug",
    ("kind",))


# ---------------------------------------------------- shared readbacks
def serve_shed_total(deployment: str) -> float:
    """Cumulative ingress sheds for one deployment (every ``shed*``
    outcome): the one definition the serve autoscaler's shed signal and
    the pool's SLO guard both read."""
    total = 0.0
    for _name, key, value in SERVE_REQ_OUTCOMES.samples():
        tags = dict(key)
        if tags.get("deployment") == deployment and \
                str(tags.get("outcome", "")).startswith("shed"):
            total += value
    return total
