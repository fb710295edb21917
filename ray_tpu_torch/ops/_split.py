"""Split-K layout arithmetic shared by the decode-attention kernels'
wrappers (``decode_attention`` over a dense cache, ``paged_decode_attention``
over a paged arena).

Both CUDA kernels cut each slot's token range into ``splits`` chunks of
whole 64-token tiles; one block per (slot, group tile of query heads,
chunk) writes an unnormalised partial into an fp32 workspace, and
``split_combine_kernel`` (``csrc/split_combine.cuh``) merges a row's live
partials. The layout is decided here from shapes alone: reading
``positions`` would make every tick wait for the device.
"""

from __future__ import annotations

import torch

SPLIT_TILE = 64              # tokens per tile, the unit of a split
BLOCKS_PER_SM = 8            # split blocks the chooser aims for per SM
MAX_SPLITS = 65535           # the kernels' grid.z


def group_tile(group: int) -> int:
    """Query heads a kernel block serves: the largest of 8, 4, 2, 1 that
    divides the group."""
    return next(gt for gt in (8, 4, 2, 1) if group % gt == 0)


def chunk_tokens(tokens: int, splits: int) -> int:
    """Tokens each of ``splits`` chunks over ``tokens`` covers: whole
    64-token tiles."""
    tiles = -(-tokens // SPLIT_TILE)
    return -(-tiles // splits) * SPLIT_TILE


def choose_splits(tokens: int, rows: int, num_sms: int) -> int:
    """The split count over a slot's ``tokens`` for ``rows`` (slot, group
    tile) pairs: enough chunks that the blocks number about
    ``BLOCKS_PER_SM`` per SM, each chunk at least one tile, and no chunk
    empty."""
    tiles = -(-tokens // SPLIT_TILE)
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * num_sms // rows)))
    chunk_tiles = -(-tiles // want)
    return min(-(-tiles // chunk_tiles), MAX_SPLITS)


def workspace(workspaces: dict, dev: torch.device, stream: int,
              numel: int) -> torch.Tensor:
    """The fp32 workspace kept in ``workspaces`` for (device, stream),
    replaced by a larger one when ``numel`` outgrows it. Calls on one
    stream run in order, so one call's split and combine kernels never
    meet another's; the caller holds its lock from here through the
    launch (ctypes drops the GIL)."""
    ws = workspaces.get((dev.index, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=dev)
        workspaces[(dev.index, stream)] = ws
    return ws
