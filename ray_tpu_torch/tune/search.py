"""Search spaces + basic variant generation (the port of
``ray_tpu/tune/search.py``: pure Python, the same ``random.Random(seed)``
streams, so a seed gives JAX's variants and TPE proposals exactly).

Reference: ``python/ray/tune/search`` — the sampling primitives
(``tune.choice/uniform/loguniform/randint``), ``tune.grid_search``, and the
``BasicVariantGenerator`` that expands grid axes into the cross product and
draws ``num_samples`` random samples of the remaining distributions.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class LogUniform(Domain):
    def __init__(self, low, high):
        import math

        self.log_low, self.log_high = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.log_low, self.log_high))


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class GridSearch:
    def __init__(self, values):
        self.values = list(values)


def choice(categories) -> Categorical:
    return Categorical(categories)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def grid_search(values) -> GridSearch:
    return GridSearch(values)


def sample_from(fn: Callable[[Dict], Any]):
    return _SampleFrom(fn)


class _SampleFrom(Domain):
    def __init__(self, fn):
        self.fn = fn

    def sample(self, rng):
        return self.fn  # resolved after the rest of the config


class Searcher:
    """Pluggable search-algorithm interface (reference:
    ``python/ray/tune/search/searcher.py`` Searcher ABC — BayesOpt /
    HyperOpt / Optuna all plug in through it). Implement these three
    methods and pass an instance as ``TuneConfig.search_alg``; the
    controller calls ``configure`` once with the resolved space, then
    alternates ``suggest`` / ``on_trial_complete``. Instances must be
    picklable: experiment restore resurrects the searcher WITH its
    observation history."""

    def configure(self, param_space: Dict[str, Any],
                  metric: Optional[str], mode: str,
                  seed: Optional[int] = None) -> None:
        raise NotImplementedError

    def suggest(self) -> Dict[str, Any]:
        """The next trial's config."""
        raise NotImplementedError

    def on_trial_complete(self, config: Dict[str, Any],
                          score: float) -> None:
        """Feed a finished trial's final RAW metric value back. The
        controller does NOT orient it: apply the ``mode`` received in
        :meth:`configure` yourself (min => lower is better)."""
        raise NotImplementedError


class TPESearch(Searcher):
    """Tree-structured Parzen Estimator search (model-based BayesOpt-class
    searcher; reference: ``python/ray/tune/search/`` hosts HyperOpt — whose
    core algorithm is TPE — plus BayesOpt/Optuna integrations. This build
    implements the algorithm natively on numpy instead of wrapping an
    external library).

    After ``n_startup`` random trials, observations are split at the
    ``gamma`` quantile into good/bad sets; numeric dimensions model each set
    with a Gaussian kernel density, categorical dimensions with smoothed
    counts, and each suggestion maximizes the acquisition l(x)/g(x) over
    ``n_candidates`` draws from the good model — the classic TPE rule.
    """

    def __init__(self, n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._space: Dict[str, Any] = {}
        self._metric: Optional[str] = None
        self._mode = "max"
        self._history: List[tuple] = []  # (config, score)

    def configure(self, param_space: Dict[str, Any], metric: Optional[str],
                  mode: str, seed: Optional[int] = None) -> None:
        if metric is None:
            raise ValueError(
                "TPESearch needs TuneConfig.metric set: without scores the "
                "model never trains and every trial would be a silent "
                "random draw")
        if any(isinstance(v, GridSearch) for v in param_space.values()):
            raise ValueError(
                "grid_search() dimensions are exhaustive by contract and "
                "a model-based searcher samples instead of enumerating — "
                "use tune.choice() for TPE-searchable categoricals, or "
                "drop search_alg to run the full grid")
        self._space = dict(param_space)
        self._metric = metric
        self._mode = mode
        # Seed only a fresh searcher: a restored one (non-empty history)
        # must keep its pickled RNG state or post-restore suggestions would
        # replay the pre-crash random stream and duplicate early trials.
        if seed is not None and not self._history:
            self.rng = random.Random(seed)

    # ------------------------------------------------------------ internals
    def _split(self):
        """(good, bad) configs, best-first by oriented score."""
        hist = sorted(self._history, key=lambda t: t[1],
                      reverse=(self._mode == "max"))
        n_good = max(1, int(len(hist) * self.gamma))
        return [c for c, _ in hist[:n_good]], [c for c, _ in hist[n_good:]]

    @staticmethod
    def _numeric_bounds(dom):
        if isinstance(dom, LogUniform):
            return dom.log_low, dom.log_high
        if isinstance(dom, (Uniform, RandInt)):
            return float(dom.low), float(dom.high)
        raise TypeError(dom)

    @staticmethod
    def _to_internal(dom, v):
        import math

        return math.log(v) if isinstance(dom, LogUniform) else float(v)

    @staticmethod
    def _from_internal(dom, x):
        import math

        lo, hi = TPESearch._numeric_bounds(dom)
        x = min(max(x, lo), hi)
        if isinstance(dom, LogUniform):
            return math.exp(x)
        if isinstance(dom, RandInt):
            return min(int(x), dom.high - 1)
        return x

    def _suggest_numeric(self, key, dom, good, bad):
        import math

        lo, hi = self._numeric_bounds(dom)
        span = hi - lo

        def pts(configs):
            return [self._to_internal(dom, c[key]) for c in configs
                    if key in c]

        gpts, bpts = pts(good), pts(bad)
        if not gpts:
            return None
        bw_g = max(span / math.sqrt(len(gpts) + 1), 1e-6 * span + 1e-12)
        bw_b = max(span / math.sqrt(len(bpts) + 1), 1e-6 * span + 1e-12)

        def kde(x, pts_, bw):
            if not pts_:
                return 1.0 / span if span else 1.0
            s = 0.0
            for p in pts_:
                z = (x - p) / bw
                s += math.exp(-0.5 * z * z)
            return s / (len(pts_) * bw) + 1e-12

        best_x, best_score = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(gpts)
            x = min(max(self.rng.gauss(center, bw_g), lo), hi)
            score = kde(x, gpts, bw_g) / kde(x, bpts, bw_b)
            if score > best_score:
                best_x, best_score = x, score
        return self._from_internal(dom, best_x)

    def _suggest_categorical(self, key, values, good, bad):
        def counts(configs):
            c = {v: 1.0 for v in map(_hashable, values)}  # +1 smoothing
            for cfg in configs:
                h = _hashable(cfg.get(key))
                if h in c:
                    c[h] += 1.0
            total = sum(c.values())
            return {v: n / total for v, n in c.items()}

        # l(v)/g(v) over the discrete support
        pg, pb = counts(good), counts(bad)
        best = max(values, key=lambda v: pg[_hashable(v)] / pb[_hashable(v)])
        return best

    # ------------------------------------------------------------ public
    def suggest(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {}
        use_model = len(self._history) >= self.n_startup
        good, bad = self._split() if use_model else ([], [])
        for k, dom in self._space.items():
            if isinstance(dom, Categorical):
                cfg[k] = (self._suggest_categorical(k, dom.categories, good,
                                                    bad)
                          if use_model else dom.sample(self.rng))
            elif isinstance(dom, _SampleFrom):
                cfg[k] = None
            elif isinstance(dom, (Uniform, LogUniform, RandInt)):
                v = (self._suggest_numeric(k, dom, good, bad)
                     if use_model else None)
                cfg[k] = dom.sample(self.rng) if v is None else v
            elif isinstance(dom, Domain):
                cfg[k] = dom.sample(self.rng)
            else:
                cfg[k] = dom
        for k, dom in self._space.items():
            if isinstance(dom, _SampleFrom):
                cfg[k] = dom.fn(cfg)
        return cfg

    def on_trial_complete(self, config: Dict[str, Any],
                          score: float) -> None:
        self._history.append((dict(config), float(score)))


def _hashable(v):
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


class BasicVariantGenerator:
    """Cross product of grid axes × num_samples draws of distributions."""

    def __init__(self, num_samples: int = 1, seed: Optional[int] = None):
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self, param_space: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        grid_keys = [k for k, v in param_space.items()
                     if isinstance(v, GridSearch)]
        grids = [param_space[k].values for k in grid_keys]
        for _ in range(self.num_samples):
            for combo in itertools.product(*grids) if grids else [()]:
                cfg: Dict[str, Any] = {}
                for k, v in param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, _SampleFrom):
                        cfg[k] = None  # placeholder, resolved below
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                for k, v in param_space.items():
                    if isinstance(v, _SampleFrom):
                        cfg[k] = v.fn(cfg)
                yield cfg
