"""The port's runtime: serve replicas as processes of their own
(:mod:`~ray_tpu_torch.runtime.replica`) and the controller that starts,
probes, drains and replaces them (:mod:`~ray_tpu_torch.runtime.controller`).
It stands where the JAX package's actor core stands (ROADMAP.md, the
re-anchor's choice of the port's runtime): ``torch.multiprocessing``
processes forked from one fork server, and pipes, a ``torch.distributed`` store for the KV."""
