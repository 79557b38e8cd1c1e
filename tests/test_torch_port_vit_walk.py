"""The key-tile walk of kernels E and F's bf16 body (csrc/vit_flash.cu,
VitSrc), through its plain twin `ops/vit_kernels.vit_tile_walk`, against
the dense visibility mask: a query sees a key of its own segment (E) and,
for F, of its own window of win_len tokens. The walk's proofs must hold
for every block of 64, 128 or 192 query rows (one, two or three consumer
warpgroups):
- every pair in a "whole" tile is visible (the kernel takes no mask there);
- no pair in a "skip" tile is visible (the kernel never loads it);
- every visible pair lies in a walked tile.
Also the wrapper's operand check for the kernel's TMA maps. CPU only, no
JAX: exact comparisons of booleans and strides."""

import shutil

import numpy as np
import pytest
import torch

from infinitevl_tpu_torch.ops.vit_kernels import (
    TILE,
    tma_operand,
    vit_tile_walk,
    vit_warpgroups,
)

LAYOUTS = ("one", "three", "three_pads", "ragged")
WIN_LENS = (0, 1, 40, 64, 100, 1024)  # 0: kernel E; above: kernel F


def _segments(layout: str, win_len: int) -> np.ndarray:
    """Segment ids of one layout. E: one segment, three of unequal length,
    three with pads (-1) scattered over them, one segment at a ragged
    length. F (window order, S a multiple of win_len): windows without
    pads, three-segment ids across the windows, window ids with pads
    (-2 - w) scattered, and a ragged length where win_len allows one."""
    rng = np.random.default_rng(0)
    L = win_len
    n = 1000 if layout == "ragged" else 2048
    S = n if L == 0 else L * -(-n // L)
    if layout in ("one", "ragged"):
        return np.zeros(S, np.int32) if L == 0 else (np.arange(S) // L).astype(np.int32)
    seg = np.zeros(S, np.int32)
    seg[S * 2 // 5: S * 3 // 4] = 1
    seg[S * 3 // 4:] = 2
    if layout == "three_pads":
        pads = rng.permutation(S)[: S // 50]
        seg[pads] = -1 if L == 0 else -2 - pads // L
    return seg


def _visible(seg: np.ndarray, win_len: int) -> np.ndarray:
    vis = seg[:, None] == seg[None, :]
    if win_len:
        w = np.arange(seg.size) // win_len
        vis &= w[:, None] == w[None, :]
    return vis


@pytest.mark.parametrize("cwg", (1, 2, 3))
@pytest.mark.parametrize("win_len", WIN_LENS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_proofs_hold(layout, win_len, cwg):
    seg = _segments(layout, win_len)
    S = seg.size
    vis = _visible(seg, win_len)
    block = cwg * TILE
    walk = vit_tile_walk(torch.from_numpy(seg), win_len, block)
    assert len(walk) == -(-S // block)
    walked = np.zeros_like(vis)
    kinds = {"whole": 0, "skip": 0, "mask": 0}
    for b, tiles in enumerate(walk):
        rows = slice(b * block, min((b + 1) * block, S))
        assert tiles, "a block walks at least its own rows' keys"
        for k0, kind in tiles:
            keys = slice(k0, min(k0 + TILE, S))
            pairs = vis[rows, keys]
            kinds[kind] += 1
            if kind == "whole":
                assert pairs.shape == (block, TILE) and pairs.all(), (b, k0)
            elif kind == "skip":
                assert not pairs.any(), (b, k0)
            walked[rows, keys] = True
    assert not (vis & ~walked).any(), "a visible pair lies outside the walk"
    # what the walk proves in the layouts the model sends
    if win_len % TILE:
        assert kinds["whole"] == kinds["skip"] == 0  # windows straddle tiles
    elif layout in ("one", "ragged") and S % block == 0 and win_len % block == 0:
        assert kinds["mask"] == 0 and kinds["skip"] == 0
    elif layout == "ragged" and win_len % block == 0:  # the last block is ragged
        assert kinds["mask"] > 0 and kinds["whole"] > 0 and kinds["skip"] == 0
    elif layout == "three" and win_len == 0:
        assert kinds["skip"] > 0 and kinds["whole"] > 0
    # F's walk covers the windows of its rows only: a block's keys start at
    # most win_len - 1 before its rows and end at most win_len after them
    if win_len:
        n_keys = sum(min(k0 + TILE, S) - k0 for tiles in walk for k0, _ in tiles)
        assert n_keys <= len(walk) * (2 * win_len + block + TILE)


@pytest.mark.parametrize("S, H, win_len, sms, want", [
    (9216, 16, 0, 132, 3), (4096, 16, 0, 132, 3), (2048, 16, 0, 132, 2), (1024, 16, 0, 132, 2),
    (3072, 16, 0, 132, 2), (3072, 16, 0, 114, 3),
    (9216, 16, 64, 132, 1), (9216, 16, 256, 132, 1), (9216, 16, 1024, 132, 2),
    (9216, 16, 640, 132, 1), (1000, 16, 40, 132, 1)])
def test_warpgroups_by_shape(S, H, win_len, sms, want):
    """E at the 1344x1344 image and above the gate takes three consumer
    warpgroups a block (a key tile loaded once for 192 rows) where that
    still gives two blocks an SM of the card (132 on an H100 SXM, 114 on
    the PCIe card), two at the frame's 1,024 tokens (three would leave most
    SMs idle); F two at windows of 1,024 (128 rows in one window), else one."""
    assert vit_warpgroups(S, H, win_len, sms) == want


def test_tma_operand_keeps_slices_and_copies_the_rest():
    """Slices of the [S, 3, H, D] projection are read where they lie; a
    token whose [H, D] is not dense, a dense view off a 16-byte boundary, a
    row stride that is no multiple of 16 bytes and a broadcast over tokens
    become aligned dense copies with the same values."""
    S, H, D = 70, 2, 80
    qkv = torch.randn((S, 3, H, D)).to(torch.bfloat16)
    for t in qkv.unbind(1):
        assert tma_operand(t).data_ptr() == t.data_ptr()
    flat = torch.randn(1 + S * H * D).to(torch.bfloat16)
    cases = (
        flat[1:].view(S, H, D),  # dense, base off 16 bytes
        qkv.transpose(0, 1)[0].permute(0, 2, 1).contiguous().permute(0, 2, 1),  # [H, D] strided
        torch.randn((S, H * D + 4)).to(torch.bfloat16)[:, : H * D].view(S, H, D),  # row stride
        torch.randn((1, H, D)).to(torch.bfloat16).expand(S, H, D),  # tokens 0 bytes apart
    )
    for t in cases:
        out = tma_operand(t)
        assert torch.equal(out, t)
        assert out.stride(2) == 1 and out.stride(1) == D and out.data_ptr() % 16 == 0
        assert out.stride(0) * out.element_size() % 16 == 0
    f32 = torch.randn((S, H, D))[:, :, :]
    assert tma_operand(f32).data_ptr() == f32.data_ptr()


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """The built library's name hashes every source, the headers too: an
    edit of the mainloop shared by A1, H, E and F rebuilds the library."""
    from infinitevl_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    for header in ("swa_fwd_wgmma.cuh", "common.cuh"):
        path = csrc / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = _build.library_path()
        assert after != before
        before = after
