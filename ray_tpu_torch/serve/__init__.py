"""Serving-plane pieces of the port that the engine's users call:
:mod:`ray_tpu_torch.serve.kv_transfer`, the KV-block transfer between a
prefill-role and a decode-role engine. The serve runtime itself (the
deployments, the router, the shm channel) is not ported yet: ROADMAP.md
queue A, item 6."""
