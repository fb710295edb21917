"""The sharded trainer's world-4 cases (fsdp=4, fsdp x tensor, tensor=4
with 2 kv heads, microbatches, remat, head dim 128, the seq layouts),
each against one process and JAX's ShardedTrainer. Split from
``tests/test_torch_sharded_training.py`` (whose cases, fixtures and
checks it uses) so the test runner can run the world-2 and world-4
process groups on different workers."""

import pytest

from test_torch_sharded_training import (CASES, SHARDED_CASES, _cases,
                                         _check_sharded, _check_steps,
                                         _one_torch_thread, spawned)

WORLDS = (4,)


@pytest.mark.parametrize("case", _cases(WORLDS))
def test_sharded_steps_match_one_process_and_jax(spawned, case):
    _check_steps(spawned, case)


@pytest.mark.parametrize("case", [c for c in SHARDED_CASES
                                  if CASES[c][0] in WORLDS])
def test_params_and_moments_actually_sharded(spawned, case):
    _check_sharded(spawned, case)
