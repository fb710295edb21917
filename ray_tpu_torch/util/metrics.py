"""User-facing metrics: Counter / Gauge / Histogram + Prometheus text
export (the port of ``ray_tpu/util/metrics.py``, kept line for line so
the same calls render the same text, byte for byte).

A process-local registry, as in the JAX package. The serving process
renders its own registry and each live replica process's samples
(:func:`collect_samples`, fetched over the replica's control pipe) at
the ingress's ``GET /metrics``
(:func:`ray_tpu_torch.runtime.controller.ServeController.metrics_text`),
where the JAX package's dashboard merges its node agents' ``/metrics``.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0)


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    @property
    def name(self) -> str:
        return self._name

    @property
    def description(self) -> str:
        return self._description

    @property
    def tag_keys(self) -> Tuple[str, ...]:
        return self._tag_keys

    def samples(self) -> List[Tuple[str, Tuple, float]]:
        """Current (name, label_tuple, value) samples — the push-plane
        snapshot the metrics pusher ships to the head TSDB."""
        return []

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        return tuple(sorted(merged.items()))

    def _render_labels(self, key: Tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in key)
        return "{" + inner + "}"


class Counter(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = defaultdict(float)

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] += value

    def samples(self):
        with self._lock:
            return [(self._name, key, v) for key, v in self._values.items()]

    def render(self) -> List[str]:
        out = [f"# HELP {self._name} {self._description}",
               f"# TYPE {self._name} counter"]
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self._name}{self._render_labels(key)} {v}")
        return out


class Gauge(Metric):
    def __init__(self, name, description="", tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] = value

    def samples(self):
        with self._lock:
            return [(self._name, key, v) for key, v in self._values.items()]

    def render(self) -> List[str]:
        out = [f"# HELP {self._name} {self._description}",
               f"# TYPE {self._name} gauge"]
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self._name}{self._render_labels(key)} {v}")
        return out


class Histogram(Metric):
    def __init__(self, name, description="", boundaries=DEFAULT_BUCKETS,
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self._bounds = tuple(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = defaultdict(float)
        self._totals: Dict[Tuple, int] = defaultdict(int)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self._bounds) + 1))
            counts[bisect.bisect_left(self._bounds, value)] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def render(self) -> List[str]:
        out = [f"# HELP {self._name} {self._description}",
               f"# TYPE {self._name} histogram"]
        with self._lock:
            for key, counts in self._counts.items():
                cum = 0
                for bound, c in zip(self._bounds, counts):
                    cum += c
                    labels = dict(key)
                    labels["le"] = str(bound)
                    inner = ",".join(f'{k}="{v}"'
                                     for k, v in sorted(labels.items()))
                    out.append(f"{self._name}_bucket{{{inner}}} {cum}")
                labels = dict(key)
                labels["le"] = "+Inf"
                inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
                out.append(f"{self._name}_bucket{{{inner}}} {self._totals[key]}")
                out.append(
                    f"{self._name}_sum{self._render_labels(key)} {self._sums[key]}")
                out.append(
                    f"{self._name}_count{self._render_labels(key)} {self._totals[key]}")
        return out


    def samples(self):
        # Histograms ship their sum and count (rate + mean latency are
        # derivable at query time; per-bucket series would multiply the
        # TSDB's series count by the bucket count).
        with self._lock:
            out = []
            for key, total in self._totals.items():
                out.append((f"{self._name}_count", key, float(total)))
                out.append((f"{self._name}_sum", key, self._sums[key]))
            return out

    def bucket_snapshot(self, tags: Optional[Dict[str, str]] = None
                        ) -> Tuple[Tuple[float, ...], List[int], int]:
        """``(bounds, per-bucket counts, total)`` merged across every
        label set matching ``tags`` (a subset filter; ``None`` = all).
        In-process consumers (the chip-pool SLO guard) diff successive
        snapshots to score a bounded window instead of the lifetime
        distribution."""
        want = tuple(sorted((tags or {}).items()))
        merged = [0] * (len(self._bounds) + 1)
        total = 0
        with self._lock:
            for key, counts in self._counts.items():
                kd = dict(key)
                if any(kd.get(k) != v for k, v in want):
                    continue
                for i, c in enumerate(counts):
                    merged[i] += c
                total += self._totals[key]
        return self._bounds, merged, total

    @staticmethod
    def percentile_from(bounds: Sequence[float], counts: Sequence[int],
                        q: float) -> Optional[float]:
        """Upper-bound percentile estimate from bucket counts (the last
        finite bound stands in for the +Inf bucket). ``None`` when the
        window holds no observations."""
        total = sum(counts)
        if total <= 0:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c > 0:
                return (bounds[i] if i < len(bounds)
                        else bounds[-1] if bounds else float("inf"))
        return bounds[-1] if bounds else float("inf")


def prometheus_text() -> str:
    """Render every registered metric (the /metrics endpoint body)."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        lines.extend(m.render())
    return "\n".join(lines) + "\n"


def all_metrics() -> List[Metric]:
    with _registry_lock:
        return list(_registry)


def collect_samples() -> List[Tuple[str, Tuple, float]]:
    """Snapshot every registered metric's samples (push-plane payload)."""
    out: List[Tuple[str, Tuple, float]] = []
    for m in all_metrics():
        out.extend(m.samples())
    return out
