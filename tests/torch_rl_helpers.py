"""Module-level classes and builders of the RL loop's CPU tests: the
replica processes and learner processes import this module by name, so it
imports neither JAX nor the JAX package."""

import os

import numpy as np
import torch

from ray_tpu_torch._private import cuda_monitor
from ray_tpu_torch.llm import ContinuousLlamaDeployment
from ray_tpu_torch.models import llama as tl

# The loop's policy: a tiny fp32 Llama. Learner and deployment both draw
# it from seed 0 on the CPU (the same init on the same device type).
CFG = tl.LlamaConfig.tiny(dtype=torch.float32)


class RLSvc(ContinuousLlamaDeployment._cls_or_fn):
    """The port's LLM deployment on the CPU, cold-started from seed 0 as
    the builders' replicas are, plus probes for the tests."""

    def __init__(self, **engine):
        super().__init__(config=CFG, device="cpu", **engine)

    def pid(self, _=None):
        return os.getpid()

    def params_bytes(self, _=None):
        """Each live param leaf's bytes, by dotted name (bit-for-bit
        comparisons across processes)."""
        from ray_tpu_torch.rl.weight_sync import _flat, _raw

        return {".".join(p): bytes(_raw(t.detach().cpu().contiguous()))
                for p, t in _flat(self.batcher.params)}


def _probe(x):
    return x @ x


class Profiled:
    """A replica whose ``work`` runs an instrumented program."""

    def __init__(self):
        self._prog = cuda_monitor.instrument(_probe, name="probe_mm")

    def work(self, n=32):
        out = None
        for _ in range(3):
            out = self._prog(torch.ones(n, n))
        return float(out.sum())


def build_ppo_learner():
    """The e2e's learner: seed 0, as the deployment's cold start."""
    from ray_tpu_torch.rl import TokenPPOLearner

    return TokenPPOLearner(CFG, params=None, lr=5e-3, rho_clip=2.0,
                           device="cpu")


def build_tiny_learner():
    """A learner for the group tests: seed 0, plain lr."""
    from ray_tpu_torch.rl import TokenPPOLearner

    return TokenPPOLearner(CFG, params=None, lr=1e-3, device="cpu")


class ToyLearner:
    """Minimal LearnerGroup-compatible learner (JAX's ``_ToyLearner``)."""

    def __init__(self):
        self.params = {"w": np.ones(4, np.float32)}

    def compute_gradients(self, batch):
        return {"w": np.zeros(4, np.float32)}, {"loss": 0.0}

    def apply_gradients(self, grads):
        pass

    def get_weights(self):
        return {k: np.asarray(v) for k, v in self.params.items()}

    def set_weights(self, weights):
        self.params = {k: np.asarray(v) for k, v in weights.items()}


class CollectiveWorker:
    """One rank of the collective tests: joins the default process group
    (gloo, ``file://``) and then two named host groups beside it."""

    def __init__(self, rank, world_size, root):
        import torch.distributed as dist

        from ray_tpu_torch.util import collective

        self.rank = rank
        dist.init_process_group("gloo", init_method=f"file://{root}/default",
                                rank=rank, world_size=world_size)
        self.groups = {
            name: collective.init_collective_group(
                world_size, rank, name, init_method=f"file://{root}/{name}")
            for name in ("g", "h")}

    def op(self, name, group, *args, **kwargs):
        """``collective.<name>(*args, group_name=group, **kwargs)``."""
        from ray_tpu_torch.util import collective

        return getattr(collective, name)(*args, group_name=group, **kwargs)

    def p2p(self, group, plan):
        """Run ``plan``: ("send", array, dst, tag) and ("recv", src, tag)
        steps in order; returns what each recv got."""
        from ray_tpu_torch.util import collective

        out = []
        for step in plan:
            if step[0] == "send":
                collective.send(step[1], step[2], group_name=group,
                                tag=step[3])
            else:
                out.append(collective.recv(step[1], group_name=group,
                                           tag=step[2]))
        return out

    def bucket_sum(self, group, array):
        """``allreduce_tensor`` of ``array`` as a CPU tensor, summed in
        place (a learner's gradient bucket)."""
        from ray_tpu_torch.util.collective.collective import _manager

        t = torch.from_numpy(np.array(array))
        out = _manager.get_group(group).allreduce_tensor(t)
        assert out is t
        return t.numpy()

    def default_group_sum(self, value):
        """An all-reduce on the default group, which the named groups
        leave alone."""
        import torch.distributed as dist

        t = torch.tensor([float(value)])
        dist.all_reduce(t)
        return float(t[0])

    def info(self, group):
        from ray_tpu_torch.util import collective

        return (collective.is_group_initialized(group),
                collective.get_rank(group),
                collective.get_collective_group_size(group),
                collective.is_group_initialized("never"))


def build_sgd_learner():
    """The PPO learner with a plain gradient step (p - lr g) in place of
    Adam: linear in the grads, so a group's averaged update compares
    with one learner's within fp32 rounding (Adam's lr g / (|g| + 1e-8)
    turns a grad's last bits into a visible step where |g| is near
    1e-8)."""
    from ray_tpu_torch.rl import TokenPPOLearner

    class SGD(TokenPPOLearner):
        def apply_gradients(self, grads):
            from ray_tpu_torch.rl.weight_sync import _flat

            by_path = dict(_flat(grads))
            with torch.no_grad():
                for path, p in _flat(self.params):
                    p.sub_(1e-2 * torch.as_tensor(by_path[path]).to(p))

    return SGD(CFG, params=None, device="cpu")
