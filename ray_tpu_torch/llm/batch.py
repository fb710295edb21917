"""Offline LLM batch inference (the port of ``ray_tpu/llm/batch.py``).

Each worker owns a
:class:`~ray_tpu_torch.models.continuous_batching.ContinuousBatcher`
built once: every batch submits all its prompts together and the engine
runs them to completion with continuous slot reuse, so short prompts do
not wait for long ones. The port has no ``ray_tpu.data``:
:func:`batch_generate` takes an iterable of column dicts and yields each
with the output column added, in order; ``concurrency > 1`` runs that
many workers, each in a replica process of the serve runtime (on a card
of its own on the GPU).
"""

from __future__ import annotations

import uuid
from collections import deque
from typing import Any, Dict, Iterable, Iterator, Optional

from ray_tpu_torch.models import llama


class LLMBatchWorker:
    """Stateful batch UDF: one engine per worker. ``device=None`` means
    ``cuda`` (raises with no GPU); ``params`` move there."""

    def __init__(self, config: llama.LlamaConfig, params=None,
                 max_new_tokens: int = 32, num_slots: int = 8,
                 max_len: int = 256, eos_token: Optional[int] = None,
                 input_column: str = "prompt_ids",
                 output_column: str = "generated_ids", device=None):
        from ray_tpu_torch.llm import _to_device
        from ray_tpu_torch.models.continuous_batching import \
            ContinuousBatcher

        device = llama.default_device(device)
        self.batcher = ContinuousBatcher(
            config, params=_to_device(params, device), num_slots=num_slots,
            max_len=max_len, eos_token=eos_token, device=device)
        self.max_new_tokens = max_new_tokens
        self.input_column = input_column
        self.output_column = output_column

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prompts = [list(map(int, p)) for p in batch[self.input_column]]
        rids = [self.batcher.submit(p, self.max_new_tokens)
                for p in prompts]
        results = self.batcher.run_to_completion()
        out = dict(batch)
        out[self.output_column] = [results[rid] for rid in rids]
        return out


def batch_generate(batches: Iterable[Dict[str, Any]],
                   config: llama.LlamaConfig, *, params=None,
                   concurrency: int = 1, max_new_tokens: int = 32,
                   num_slots: int = 8, max_len: int = 256,
                   eos_token: Optional[int] = None,
                   input_column: str = "prompt_ids",
                   output_column: str = "generated_ids",
                   device=None) -> Iterator[Dict[str, Any]]:
    """Greedy generation over batches of token-id prompts, yielded in
    order with ``output_column`` holding the generated ids. With
    ``concurrency > 1`` the workers are replica processes (a card each
    when ``device`` is ``cuda``), fed at most two batches ahead each;
    params cross as host tensors."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import _to_device

    device = llama.default_device(device)
    kwargs = dict(config=config, max_new_tokens=max_new_tokens,
                  num_slots=num_slots, max_len=max_len, eos_token=eos_token,
                  input_column=input_column, output_column=output_column)
    if concurrency <= 1:
        worker = LLMBatchWorker(params=params, device=device, **kwargs)
        for batch in batches:
            yield worker(batch)
        return
    name = f"LLMBatchWorker-{uuid.uuid4().hex[:8]}"
    # One batch at a time in a worker (its engine is not shared between
    # threads); the next ones wait in the replica's queue.
    dep = serve.deployment(
        LLMBatchWorker, name=name, num_replicas=concurrency,
        max_ongoing_requests=1,
        ray_actor_options={"num_gpus": 1} if device.type == "cuda" else {})
    handle = serve.run(dep.bind(params=_to_device(params, "cpu"),
                                device=device.type, **kwargs))
    try:
        pending: deque = deque()
        for batch in batches:
            pending.append(handle.remote(batch))
            if len(pending) >= 2 * concurrency:
                yield pending.popleft().result(timeout_s=None)
        while pending:
            yield pending.popleft().result(timeout_s=None)
    finally:
        serve.delete(name)
