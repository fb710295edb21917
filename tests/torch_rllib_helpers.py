"""Module-level envs, policy mappings and fleet members of the RL
library's CPU tests: the runner processes import this module by name, so
it imports neither JAX nor the JAX package."""

import os
import time

import numpy as np


class MatchGame:
    """``tests/test_rllib.py``'s ``_MatchGame``: each of two agents sees a
    one-hot context and earns 1.0 for picking its index."""

    N_CTX = 3
    EP_LEN = 8
    possible_agents = ["a0", "a1"]

    def __init__(self, seed=0):
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self):
        out = {}
        self._ctx = {}
        for aid in self.possible_agents:
            c = int(self._rng.integers(self.N_CTX))
            self._ctx[aid] = c
            vec = np.zeros(self.N_CTX, dtype=np.float32)
            vec[c] = 1.0
            out[aid] = vec
        return out

    def reset(self, *, seed=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action_dict):
        self._t += 1
        rewards = {aid: 1.0 if action_dict[aid] == self._ctx[aid] else 0.0
                   for aid in action_dict}
        done = self._t >= self.EP_LEN
        terms = {aid: done for aid in action_dict}
        terms["__all__"] = done
        return self._obs(), rewards, terms, {"__all__": False}, {}

    def close(self):
        pass


def policy_for(agent_id):
    """Agent ``aN`` to policy ``pN`` (JAX's test passes this as a
    lambda)."""
    return "p" + agent_id[-1]


class Member:
    """A fleet member for the manager's tests: ``value`` answers its
    index and process, ``threads`` the torch threads its calls run
    with, ``sleep`` holds its one worker."""

    def __init__(self, index):
        self.index = index

    def value(self, x):
        return (self.index, x, os.getpid())

    def threads(self):
        """``omp_get_max_threads()`` of each OpenMP runtime this process
        loaded, read on the thread running calls (before any torch op
        there, which would set it on its own)."""
        import ctypes

        with open("/proc/self/maps") as f:
            libs = sorted({line.split()[-1] for line in f
                           if "libgomp" in line or "libiomp" in line})
        return [ctypes.CDLL(p).omp_get_max_threads() for p in libs]

    def sleep(self, s):
        time.sleep(s)
        return True

    def ping(self):
        return True
