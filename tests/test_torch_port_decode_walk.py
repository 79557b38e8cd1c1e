"""The ring walk of the decode kernels A2 and D (csrc/swa_ring_flash.cu,
DecWalk), through its plain twin `ops/swa_kernels.decode_tile_walk` and
the split plan `decode_split_plan`, against the dense visibility of the
ring after the token's write (`ops/swa.ring_slot_positions`,
`sliding_window_mask`):
- every visible slot is loaded exactly once, by one split;
- no tile without a visible slot is loaded;
- a tile the kernel takes whole (no per-element mask) is visible in full;
- exactly one split owns slot m0, which holds the new token.
CPU only, no JAX: exact comparisons of booleans and integers."""

import numpy as np
import pytest
import torch

from infinitevl_tpu_torch.ops.swa import ring_slot_positions, sliding_window_mask
from infinitevl_tpu_torch.ops.swa_kernels import (
    DECODE_MIN_TILES,
    DECODE_TILE,
    decode_split_plan,
    decode_tile_walk,
)

CAP = 8192  # the 3B ring
HQ, HKV = 16, 2
CUMS = (0, 1, 63, 64, CAP - 1, CAP, CAP + 1, 20000)
SMS = (1, 8, 132)


def _visible(cap: int, cum_len: int, window: int) -> np.ndarray:
    """[cap] bool: the ring slots the token at position cum_len sees once
    it is written into slot cum_len % cap."""
    pos = ring_slot_positions(cum_len + 1, cap)
    return sliding_window_mask(torch.tensor([cum_len]), pos, window)[0].numpy()


def _check_walk(B: int, cap: int, cum_len: int, window: int, sms: int) -> None:
    plan = decode_split_plan(B, HQ, HKV, cap, cum_len, window, sms)
    walk = decode_tile_walk(plan, cap, cum_len, window)
    vis = _visible(cap, cum_len, window)
    n_vis = min(cum_len + 1, window)
    assert vis.sum() == n_vis
    assert len(walk) == plan.split
    assert (plan.split - 1) * plan.tiles_per_split < plan.n_tiles
    assert plan.n_tiles <= plan.split * plan.tiles_per_split
    assert plan.partial_shape == (() if plan.split == 1
                                  else (B * HKV, plan.split, HQ // HKV, 132))
    if plan.split > 1:  # every split but the last takes at least DECODE_MIN_TILES
        assert plan.tiles_per_split >= DECODE_MIN_TILES

    covered = np.zeros(cap, np.int64)
    m0 = cum_len % cap
    writers = [s for s, sw in enumerate(walk) if sw.writes]
    assert len(writers) == 1
    for s, sw in enumerate(walk):
        assert sw.tiles, f"split {s} walks no tile"
        assert set(sw.masked) <= set(sw.tiles)
        for t in sw.tiles:
            slots = slice(t * DECODE_TILE, min((t + 1) * DECODE_TILE, cap))
            covered[slots] += 1
            assert vis[slots].any(), f"tile {t} loaded with no visible slot"
            if t not in sw.masked:
                assert vis[slots].all() and slots.stop - slots.start == DECODE_TILE, \
                    f"tile {t} taken whole with slots it must not see"
        if sw.writes:
            assert m0 // DECODE_TILE in sw.tiles
    assert (covered[vis] == 1).all(), "a visible slot loaded twice or never"
    assert covered.max() <= 1
    # slot m0 holds the new token, the query itself
    assert int(ring_slot_positions(cum_len + 1, cap)[m0]) == cum_len and vis[m0]
    # only what is visible is loaded: one tile more than the visible slots
    # fill where the window's edge falls inside a tile
    n_loaded = sum(len(sw.tiles) for sw in walk)
    assert n_loaded == plan.n_tiles
    assert n_loaded <= -(-n_vis // DECODE_TILE) + 1
    # elementwise masks only at the window's lower edge, at the write point
    # and on a ragged last tile
    assert sum(len(sw.masked) for sw in walk) <= 2 + (cap % DECODE_TILE > 0)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B", (1, 4))
@pytest.mark.parametrize("window", (CAP, 4096))
@pytest.mark.parametrize("cum_len", CUMS)
def test_decode_walk_covers_the_window(cum_len, window, B, sms):
    _check_walk(B, CAP, cum_len, window, sms)


@pytest.mark.parametrize("cap,window", ((200, 200), (200, 130), (512, 512), (64, 64), (100, 1)))
def test_decode_walk_small_and_ragged_rings(cap, window):
    """Rings that are no multiple of the tile (a ragged last tile, masked)
    and short windows, at every write position over two laps."""
    for cum_len in range(0, 2 * cap + 3):
        for sms in (1, 132):
            _check_walk(1, cap, cum_len, window, sms)


def test_decode_plan_fills_the_card_at_3b():
    """At B 1 and a full ring the walk of 128 tiles a KV head goes to 32
    splits of 4 tiles (64 blocks on 132 SMs), under a window of half the
    ring to 33 splits of 2; at B 4 to no more blocks than SMs; at cum_len 0
    one split of one tile writes the output itself (one launch)."""
    full = decode_split_plan(1, HQ, HKV, CAP, 20000, CAP, 132)
    assert (full.n_tiles, full.tiles_per_split, full.split) == (128, 4, 32)
    half = decode_split_plan(1, HQ, HKV, CAP, 20000, CAP // 2, 132)
    assert (half.n_tiles, half.tiles_per_split, half.split) == (65, 2, 33)
    assert decode_split_plan(4, HQ, HKV, CAP, 20000, CAP, 132).split * 4 * HKV <= 132
    first = decode_split_plan(1, HQ, HKV, CAP, 0, CAP, 132)
    assert (first.n_tiles, first.split, first.partial_shape) == (1, 1, ())
