"""Packed coordinate keys (counterpart of `occuseg_tpu/core/coords.py`).

Every set of active sites is a sorted array of packed int64 keys,

    key = (batch << 36) | morton12(z, y, x),

where `morton12` interleaves the three 12-bit coordinates of the 4096^3
input window. Membership queries are `searchsorted` plus equality, on
int64 tensors of any device; the functions here are bit-identical to the
JAX package's. The stride-2 parent key is the spatial bits shifted right
by 3, strictly monotone in the key, so a sorted level's parents come out
sorted. Padding rows carry `KEY_PAD`, which sorts after every real key.
"""

from __future__ import annotations

import torch

AXIS_BITS = 12
AXIS_SIZE = 1 << AXIS_BITS  # 4096
SPATIAL_BITS = 3 * AXIS_BITS  # 36 interleaved bits
_SPATIAL_MASK = (1 << SPATIAL_BITS) - 1

# sorts strictly after any real key (real keys are < 2^62 for batch < 2^26)
KEY_PAD = 1 << 62


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of v so bit i lands at bit 3i."""
    x = v.to(torch.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact3(v: torch.Tensor) -> torch.Tensor:
    """Inverse of _spread3: collect bits 0, 3, 6, ... into the low bits."""
    x = v & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def pack(coords: torch.Tensor) -> torch.Tensor:
    """Morton int64 keys of int coords [..., 4] (b, z, y, x). Rows with a
    negative batch or a spatial component outside [0, 4096) (the -1
    padding) map to KEY_PAD."""
    c = coords.to(torch.int64)
    b, z, y, x = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    morton = (_spread3(z) << 2) | (_spread3(y) << 1) | _spread3(x)
    key = (b << SPATIAL_BITS) | morton
    sp = c[..., 1:]
    valid = ((sp >= 0) & (sp < AXIS_SIZE)).all(dim=-1) & (b >= 0)
    return torch.where(valid, key, KEY_PAD)


def unpack(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack`: int64 keys [N] -> int32 coords [N, 4]; KEY_PAD
    rows -> -1."""
    morton = keys & _SPATIAL_MASK
    out = torch.stack([keys >> SPATIAL_BITS, _compact3(morton >> 2),
                       _compact3(morton >> 1), _compact3(morton)],
                      dim=-1).to(torch.int32)
    return torch.where((keys >= KEY_PAD)[..., None], -1, out)


def parent_keys(keys: torch.Tensor) -> torch.Tensor:
    """Stride-2 parent key: spatial Morton bits >> 3, batch bits kept.
    Strictly monotone in `keys`."""
    parent = (keys & ~_SPATIAL_MASK) | ((keys & _SPATIAL_MASK) >> 3)
    return torch.where(keys >= KEY_PAD, KEY_PAD, parent)


def neighbor_keys(coords: torch.Tensor, delta) -> torch.Tensor:
    """Keys of coords [..., 4] shifted by a spatial delta [3] (computed
    from the coordinates, so a border site never wraps into another axis'
    field); out of the domain -> KEY_PAD."""
    d = torch.as_tensor(delta, dtype=coords.dtype, device=coords.device)
    return pack(torch.cat([coords[..., :1], coords[..., 1:] + d], dim=-1))


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in a KEY_PAD-padded sorted key array, int32
    [Q]; -1 where the key is absent (searchsorted's left side, as
    `jnp.searchsorted`)."""
    pos = torch.searchsorted(sorted_keys, queries.contiguous())
    pos = pos.clamp(max=sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos] == queries) & (queries < KEY_PAD)
    return torch.where(hit, pos, -1).to(torch.int32)


def sort_by_key(keys: torch.Tensor, *arrays: torch.Tensor):
    """Keys sorted ascending (a stable sort, as `jnp.argsort`), companion
    row arrays permuted alike, and the order."""
    skeys, order = torch.sort(keys, stable=True)
    return (skeys,) + tuple(a[order] for a in arrays) + (order,)


def unique_consecutive(sorted_keys: torch.Tensor):
    """(is_first bool [N], segment_id int32 [N], num_unique 0-d int32) of
    a sorted KEY_PAD-padded key array: True at the first row of each
    distinct real key, the 0-based index of each row's key (padding rows
    get N), and the count of distinct real keys."""
    valid = sorted_keys < KEY_PAD
    prev = torch.cat([sorted_keys[:1] - 1, sorted_keys[:-1]])
    is_first = (sorted_keys != prev) & valid
    segment_id = torch.cumsum(is_first.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    segment_id = torch.where(valid, segment_id, sorted_keys.shape[0])
    num_unique = is_first.to(torch.int32).sum(dtype=torch.int32)
    return is_first, segment_id.to(torch.int32), num_unique


def compact_unique(sorted_keys: torch.Tensor, cap: int):
    """(unique_keys int64 [cap], first_row int32 [cap], num_unique 0-d
    int32): the distinct real keys of a sorted array left-packed and
    padded with KEY_PAD, the row where each first appears (-1 for pad
    slots), and their count (at most cap). Left-packed by a search of the
    running count of firsts for 1..cap (int32 on both sides), as the JAX
    package does, with no scatter."""
    is_first, _, num_unique = unique_consecutive(sorted_keys)
    csum = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32)
    targets = torch.arange(1, cap + 1, dtype=torch.int32,
                           device=sorted_keys.device)
    pos = torch.searchsorted(csum, targets).clamp(
        max=sorted_keys.shape[0] - 1)
    valid = targets <= num_unique
    unique_keys = torch.where(valid, sorted_keys[pos], KEY_PAD)
    first_row = torch.where(valid, pos, -1).to(torch.int32)
    return unique_keys, first_row, torch.clamp(num_unique, max=cap)
