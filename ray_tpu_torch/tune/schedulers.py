"""Trial schedulers: FIFO, ASHA (async successive halving), median stopping,
PBT and PB2 (the port of ``ray_tpu/tune/schedulers.py``: the same
``np.random.default_rng(seed)`` draws, so PBT and PB2 decide as JAX's do
on the same reported metrics).

Reference: ``python/ray/tune/schedulers`` — ``AsyncHyperBandScheduler``
(async_hyperband.py) promotes trials through rungs, stopping those below the
rung's top-1/reduction_factor quantile; ``MedianStoppingRule`` stops trials
whose best result is below the median of peers at the same step.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, step: int, value: float) -> str:
        return CONTINUE


class AsyncHyperBandScheduler:
    """ASHA. ``time_attr`` steps are reported results (1-indexed)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4):
        assert mode in ("max", "min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        # rung thresholds: milestones grace * rf^k up to max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.recorded: Dict[int, List[float]] = collections.defaultdict(list)

    def _better(self, a: float, b: float) -> bool:
        return a >= b if self.mode == "max" else a <= b

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        for rung in reversed(self.rungs):
            if step == rung:
                values = self.recorded[rung]
                values.append(value)
                if len(values) < self.rf:
                    return CONTINUE  # not enough peers yet: be permissive
                ordered = sorted(values, reverse=(self.mode == "max"))
                cutoff = ordered[max(len(ordered) // self.rf - 1, 0)]
                if not self._better(value, cutoff):
                    return STOP
        return CONTINUE


class MedianStoppingRule:
    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.best: Dict[str, float] = {}
        self.histories: Dict[str, List[float]] = collections.defaultdict(list)

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        self.histories[trial_id].append(value)
        if step <= self.grace:
            return CONTINUE
        peers = [max(h) if self.mode == "max" else min(h)
                 for tid, h in self.histories.items() if tid != trial_id]
        if len(peers) < self.min_samples:
            return CONTINUE
        peers_sorted = sorted(peers)
        median = peers_sorted[len(peers_sorted) // 2]
        mine = max(self.histories[trial_id]) if self.mode == "max" \
            else min(self.histories[trial_id])
        ok = mine >= median if self.mode == "max" else mine <= median
        return CONTINUE if ok else STOP


EXPLOIT = "EXPLOIT"


class PopulationBasedTraining:
    """PBT (reference: ``python/ray/tune/schedulers/pbt.py``): at every
    ``perturbation_interval`` reported steps, a trial in the bottom
    quantile clones the checkpoint + config of a random top-quantile peer
    and perturbs the mutated hyperparameters (exploit + explore). The
    controller performs the fork; this class decides who forks from whom
    and how configs mutate."""

    requires_checkpoints = True

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_mutations: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        assert mode in ("max", "min")
        assert 0.0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = dict(hyperparam_mutations or {})
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        import numpy as _np

        self._rng = _np.random.default_rng(seed)
        self._latest: Dict[str, float] = {}   # trial -> last metric value
        self._configs: Dict[str, Dict] = {}   # trial -> current config
        self.exploit_count = 0

    def on_trial_config(self, trial_id: str, config: Dict) -> None:
        self._configs[trial_id] = dict(config)

    def _quantiles(self):
        ordered = sorted(self._latest,
                         key=lambda t: self._latest[t],
                         reverse=(self.mode == "max"))
        k = max(1, int(len(ordered) * self.quantile))
        return ordered[:k], ordered[-k:]

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        self._latest[trial_id] = value
        if step % self.interval != 0 or len(self._latest) < 2:
            return CONTINUE
        top, bottom = self._quantiles()
        if trial_id in bottom and trial_id not in top:
            return EXPLOIT
        return CONTINUE

    def exploit(self, trial_id: str):
        """Pick a donor from the top quantile and build the perturbed
        config. Returns ``(donor_trial_id, new_config)``. Pure: the
        controller may still decline the fork (no donor checkpoint yet) —
        bookkeeping moves in :meth:`commit_exploit` once it commits."""
        top, _ = self._quantiles()
        donors = [t for t in top if t != trial_id]
        if not donors:
            return None, None
        donor = donors[int(self._rng.integers(0, len(donors)))]
        new_config = self._explore(dict(self._configs.get(donor, {})))
        return donor, new_config

    def commit_exploit(self, trial_id: str, new_config: Dict) -> None:
        """The controller actually forked ``trial_id`` onto ``new_config``."""
        self._configs[trial_id] = dict(new_config)
        self.exploit_count += 1

    def _explore(self, config: Dict) -> Dict:
        for key, domain in self.mutations.items():
            if callable(domain):
                resampled = domain()
            elif isinstance(domain, (list, tuple)):
                resampled = domain[int(self._rng.integers(0, len(domain)))]
            else:
                resampled = None
            cur = config.get(key)
            if resampled is not None and (
                    cur is None or self._rng.random() < self.resample_p):
                config[key] = resampled
            elif isinstance(cur, (int, float)) and \
                    not isinstance(cur, bool):
                factor = 1.2 if self._rng.random() < 0.5 else 0.8
                if isinstance(cur, int):
                    # Round, and keep positive ints from ratcheting to 0
                    # (int(1*0.8) would freeze a batch-size at 0 forever).
                    new = int(round(cur * factor))
                    config[key] = max(new, 1) if cur >= 1 else new
                else:
                    config[key] = cur * factor
            elif resampled is not None:
                config[key] = resampled
        return config


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: ``tune/schedulers/pb2.py`` —
    PBT whose explore step is a GP-bandit over continuous hyperparameters
    instead of random perturbation). Exploited trials pick their next
    hyperparameters by maximizing a GP-UCB acquisition fit on the
    population's observed (hyperparams -> score improvement) history, so
    the population steers toward productive regions with far fewer trials
    than random perturbation.

    ``hyperparam_bounds`` maps each tuned key to ``(low, high)``; values
    are modeled in normalized [0, 1] with an RBF-kernel GP (numpy-native —
    population histories are tiny, so exact GP inference is cheap).
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_bounds: Optional[Dict] = None,
                 quantile_fraction: float = 0.25,
                 ucb_kappa: float = 1.0,
                 n_candidates: int = 64,
                 seed: Optional[int] = None):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed)
        if not hyperparam_bounds:
            raise ValueError("PB2 needs hyperparam_bounds={key: (lo, hi)}")
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self.ucb_kappa = ucb_kappa
        self.n_candidates = n_candidates
        self._prev_value: Dict[str, float] = {}
        # (normalized hyperparam vector, oriented score delta)
        self._observations: list = []
        self.MAX_OBS = 256

    # ------------------------------------------------------------ tracking
    def _normalize(self, config: Dict) -> Optional[list]:
        x = []
        for k, (lo, hi) in self.bounds.items():
            v = config.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return None
            x.append((float(v) - lo) / (hi - lo) if hi > lo else 0.0)
        return x

    def on_result(self, trial_id: str, step: int, value: float) -> str:
        prev = self._prev_value.get(trial_id)
        self._prev_value[trial_id] = value
        if prev is not None:
            x = self._normalize(self._configs.get(trial_id, {}))
            if x is not None:
                delta = value - prev
                if self.mode == "min":
                    delta = -delta
                self._observations.append((x, delta))
                del self._observations[:-self.MAX_OBS]
        return super().on_result(trial_id, step, value)

    def commit_exploit(self, trial_id: str, new_config: Dict) -> None:
        super().commit_exploit(trial_id, new_config)
        # The forked trial resumes from the DONOR's checkpointed score:
        # comparing its next report against the pre-fork value would
        # credit the checkpoint jump to the new hyperparameters and
        # poison the GP with a phantom improvement.
        self._prev_value.pop(trial_id, None)

    # ------------------------------------------------------------- explore
    def _explore(self, config: Dict) -> Dict:
        """GP-UCB selection over the bounded hyperparameters (replaces
        PBT's random perturbation)."""
        import numpy as np

        keys = list(self.bounds)
        if len(self._observations) < 4:
            # Cold start: uniform draw inside the bounds.
            for k in keys:
                lo, hi = self.bounds[k]
                config[k] = lo + (hi - lo) * float(self._rng.random())
            return config
        X = np.asarray([x for x, _ in self._observations])
        y = np.asarray([d for _, d in self._observations])
        y = (y - y.mean()) / (y.std() + 1e-9)

        def rbf(a, b, ls=0.2):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (ls * ls))

        K = rbf(X, X) + 1e-2 * np.eye(len(X))
        try:
            K_inv = np.linalg.inv(K)
        except np.linalg.LinAlgError:
            K_inv = np.linalg.pinv(K)
        cands = self._rng.random((self.n_candidates, len(keys)))
        Ks = rbf(cands, X)
        mu = Ks @ K_inv @ y
        var = np.clip(1.0 - np.einsum("ij,jk,ik->i", Ks, K_inv, Ks),
                      1e-9, None)
        best = cands[int(np.argmax(mu + self.ucb_kappa * np.sqrt(var)))]
        for k, u in zip(keys, best):
            lo, hi = self.bounds[k]
            config[k] = lo + (hi - lo) * float(u)
        return config
