"""The deployment class ``tests/test_torch_cluster_llm.py`` runs as a
cluster actor: module-level, so a forked worker imports it by name (the
cluster runtime sends classes by reference), in a module that imports no
JAX."""

from ray_tpu_torch import llm as tllm


class ScoringLlm(tllm.ContinuousLlamaDeployment._cls_or_fn):
    """The port's deployment with a one-argument ``score`` (a request
    ``(prompt, tokens)`` in, its logprobs out) and the launch counts of
    the worker it runs in."""

    def score(self, request):
        prompt, tokens = request
        return self.score_logprobs(prompt, tokens)

    def pid(self):
        import os

        return os.getpid()

    def modules(self):
        import sys

        return sorted(m for m in sys.modules
                      if m == "jax" or m.startswith(("jax.", "ray_tpu."))
                      or m == "ray_tpu")
