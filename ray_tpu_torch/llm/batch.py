"""Offline LLM batch inference over ``ray_tpu_torch.data`` pipelines (the
port of ``ray_tpu/llm/batch.py``).

Reference: ``python/ray/llm/_internal/batch`` — processors that run an LLM
over a Dataset with a pool of engine-owning actors. Each pool actor owns
a :class:`~ray_tpu_torch.models.continuous_batching.ContinuousBatcher`
built once: every incoming batch submits all its prompts together and the
engine runs them to completion with continuous slot reuse, so short
prompts do not wait for long ones.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ray_tpu_torch.models import llama


class LLMBatchWorker:
    """Stateful ``map_batches`` UDF: one engine per pool actor.
    ``device=None`` means ``cuda`` (raises with no GPU); ``cuda`` with no
    index is the current card (the one the pool pinned the actor to);
    ``params`` (or the object they were put as) move there."""

    def __init__(self, config: llama.LlamaConfig, params=None,
                 max_new_tokens: int = 32, num_slots: int = 8,
                 max_len: int = 256, eos_token: Optional[int] = None,
                 input_column: str = "prompt_ids",
                 output_column: str = "generated_ids", device=None):
        import ray_tpu_torch
        from ray_tpu_torch.llm import _to_device
        from ray_tpu_torch.models.continuous_batching import \
            ContinuousBatcher

        if isinstance(params, ray_tpu_torch.ObjectRef):
            params = ray_tpu_torch.get(params)
        device = llama.default_device(device)
        if device.type == "cuda" and device.index is None:
            import torch

            device = torch.device("cuda", torch.cuda.current_device())
        self.batcher = ContinuousBatcher(
            config, params=_to_device(params, device), num_slots=num_slots,
            max_len=max_len, eos_token=eos_token, device=device)
        self.max_new_tokens = max_new_tokens
        self.input_column = input_column
        self.output_column = output_column

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        prompts = [list(map(int, p)) for p in batch[self.input_column]]
        rids = [self.batcher.submit(p, self.max_new_tokens)
                for p in prompts]
        results = self.batcher.run_to_completion()
        out = dict(batch)
        out[self.output_column] = [results[rid] for rid in rids]
        return out


def batch_generate(ds, config: llama.LlamaConfig, *, params=None,
                   concurrency: int = 1, max_new_tokens: int = 32,
                   num_slots: int = 8, max_len: int = 256,
                   eos_token: Optional[int] = None,
                   input_column: str = "prompt_ids",
                   output_column: str = "generated_ids", device=None):
    """Greedy generation over a Dataset of token-id prompts.

    Returns a Dataset with ``output_column`` holding the generated ids
    (reference: the build_llm_processor entry of ``llm/_internal/batch``).
    ``concurrency`` engine actors of the core API each build the model
    once, on ``device`` (``cuda`` unless the caller asks for the CPU),
    and stream the dataset's blocks through their continuous batcher;
    the pool is torn down once every output block is made. With
    ``device`` ``cuda`` (no index) the pool reserves a card for each
    actor (``num_gpus=1``), and raises when the process sees fewer
    cards than ``concurrency``; an indexed card is shared by them all.
    Params go into the object store once (held there by reference: a
    card's tensors stay on it) instead of once per actor.
    """
    import ray_tpu_torch

    device = llama.default_device(device)
    if params is not None and not isinstance(params, ray_tpu_torch.ObjectRef):
        params = ray_tpu_torch.put(params)
    card_each = device.type == "cuda" and device.index is None
    return ds.map_batches(
        LLMBatchWorker,
        concurrency=concurrency,
        num_gpus=1 if card_each else None,
        fn_constructor_kwargs=dict(
            config=config, params=params, max_new_tokens=max_new_tokens,
            num_slots=num_slots, max_len=max_len, eos_token=eos_token,
            input_column=input_column, output_column=output_column,
            device=device),
    )
