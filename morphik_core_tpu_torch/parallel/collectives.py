"""Collectives over one mesh axis for a single-controller mesh: the ops
XLA inserts for the reference under `shard_map` / GSPMD.

Each takes the axis's per-shard tensors, in device order, each on its own
device. The shards meet on the first shard's device by peer copies
(`Tensor.to(device, non_blocking=True)`); `all_reduce_max` sends its result
back to every other distinct device of the axis the same way (on a
repeated device it is the same tensor). `gather` and `reduce_sum` leave
theirs on the first device, where every caller merges. Concatenation
follows device order, so a top-k over a gathered list resolves ties as
`jax.lax.all_gather` + `top_k` do. One host needs no more; a faster
transport waits for a cell that measures one.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def broadcast(value: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """`value` on each of `devices`: one copy a distinct device, `value`
    itself on its own."""
    copies = {value.device: value}
    for d in devices:
        if d not in copies:
            copies[d] = value.to(d, non_blocking=True)
    return [copies[d] for d in devices]


def reduce_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' sum, added in device order on the first shard's device."""
    root = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + to_device(p, root)
    return total


def gather(parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards concatenated along `dim` in device order, on the first
    shard's device (where every caller merges them)."""
    root = parts[0].device
    return torch.cat([to_device(p, root) for p in parts], dim=dim)


def all_reduce_max(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' element-wise max on every shard's device."""
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, to_device(p, out.device))
    return broadcast(out, [p.device for p in parts])
