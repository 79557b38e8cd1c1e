"""The port's ViT, vision rope, masked scatter, multimodal forward and frame
preprocessing against the JAX package, on the CPU in fp32: inputs made
from a seed with numpy, weights carried by from_jax_numpy, the JAX config
converted field by field into the port's own.

Tolerances: integer arrays and numpy tables exact; fp32 tensors err_ratio
<= 1e-4 through the ViT and the 8-layer decoder (summation order only),
<= 1e-5 for single ops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config

import infinitevl_tpu.data.processing as jproc
import infinitevl_tpu.models.state as jstate
import infinitevl_tpu.models.vision as jvision
import infinitevl_tpu.ops.rope as jrope
import infinitevl_tpu_torch.data.processing as tproc
import infinitevl_tpu_torch.models.vision as tvision
import infinitevl_tpu_torch.ops.rope as trope
from infinitevl_tpu.config import VisionConfig, tiny_config
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.infinitevl import forward as jforward
from infinitevl_tpu.models.infinitevl import get_rope_index as jrope_index
from infinitevl_tpu.models.infinitevl import scatter_vision_embeds as jscatter
from infinitevl_tpu.models.params import init_params, init_vision_params
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.infinitevl import forward, scatter_vision_embeds
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.models.params import init_vision_params as t_init_vision_params
from infinitevl_tpu_torch.models.state import init_decoder_state
from infinitevl_tpu_torch.ops.vit_kernels import segment_flash_attention

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
OP_TOL = 1e-5

# a ViT small enough for the CPU: patch 2, merge 2, windows of 2x2 merged tokens
VCFG = VisionConfig(depth=2, hidden_size=32, intermediate_size=64, num_heads=4,
                    patch_size=2, spatial_merge_size=2, temporal_patch_size=1,
                    window_size=8, out_hidden_size=64, fullatt_block_indexes=(1,))
CFG = dataclasses.replace(tiny_config(), vision=VCFG)

GRIDS = {
    "one_image": ((1, 8, 8),),
    "padded_windows": ((1, 6, 10),),  # 3x5 merged tokens: ragged windows, pad slots
    "multi_image": ((1, 4, 4), (1, 8, 6)),
    "video": ((2, 8, 8),),  # two temporal frames, one segment each
    "equal_grids": ((1, 8, 8), (1, 8, 8)),  # the batched full-attention path
}


TCFG = to_port_config(CFG)


def err_ratio(x, ref):
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.abs(x - ref).mean() / (np.abs(ref).mean() + 1e-12)


def n_patches(grid):
    return sum(t * h * w for t, h, w in grid)


def in_feat(vcfg):
    return vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size**2


@pytest.fixture(scope="module")
def weights():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    return jp, from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("name", GRIDS)
def test_vision_rope_tables_exact(name):
    grid = GRIDS[name]
    ids_j = jrope.vision_rot_pos_ids(grid, 2)
    ids_t = trope.vision_rot_pos_ids(grid, 2)
    np.testing.assert_array_equal(ids_t, ids_j)
    for a, b in zip(trope.vision_cos_sin(ids_t, 8), jrope.vision_cos_sin(ids_j, 8)):
        np.testing.assert_array_equal(a, b)


def test_apply_rotary_vision_matches_jax():
    rng = np.random.RandomState(0)
    q, k = rng.standard_normal((2, 24, 4, 8)).astype(np.float32)
    cos, sin = jrope.vision_cos_sin(jrope.vision_rot_pos_ids(((1, 4, 6),), 2), 8)
    want = jrope.apply_rotary_vision(*map(jnp.asarray, (q, k, cos, sin)))
    got = trope.apply_rotary_vision(*map(torch.from_numpy, (q, k, cos, sin)))
    for a, b in zip(got, want):
        assert err_ratio(a, b) < OP_TOL


@pytest.mark.parametrize("name", GRIDS)
def test_vision_plan_arrays_exact(name):
    grid = GRIDS[name]
    jp = jvision.VisionPlan(grid, VCFG)
    tp = tvision.get_vision_plan(grid, TCFG.vision)
    for attr in ("num_windows", "win_len_merged", "win_len", "seq_merged", "seq",
                 "pad_seq_merged", "pad_seq", "equal_frame_len"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for attr in ("merged_gather", "merged_valid", "token_valid", "merged_inverse",
                 "win_seg", "seg_full", "cos", "sin"):
        np.testing.assert_array_equal(getattr(tp, attr), getattr(jp, attr), err_msg=attr)
    # the device copies are made once per (grid, device)
    assert tvision.plan_tensors(tp, "cpu") is tvision.plan_tensors(tp, torch.device("cpu"))
    assert tvision.plan_tensors(tp, "cpu")["seg_full"].dtype == torch.int32


@pytest.mark.parametrize("name", GRIDS)
def test_vision_forward_matches_jax(weights, name):
    jp, tp = weights
    grid = GRIDS[name]
    px = np.random.RandomState(len(name)).standard_normal(
        (n_patches(grid), in_feat(VCFG))).astype(np.float32)
    want = jvision.vision_forward(jp["visual"], VCFG, jnp.asarray(px),
                                  jvision.get_vision_plan(grid, VCFG))
    got = tvision.vision_forward(tp["visual"], TCFG.vision, torch.from_numpy(px),
                                 tvision.get_vision_plan(grid, TCFG.vision))
    assert got.shape == want.shape == (n_patches(grid) // 4, 64)
    assert err_ratio(got, want) < TOL


def test_vision_forward_through_the_flash_gate(weights, monkeypatch):
    """At or above the gate the full-attention blocks go through kernel E's
    wrapper (its plain version on the CPU), in JAX through the chunked twin:
    same features as below the gate, and the wrapper counts no launch."""
    jp, tp = weights
    grid = GRIDS["multi_image"]
    px = np.random.RandomState(3).standard_normal(
        (n_patches(grid), in_feat(VCFG))).astype(np.float32)
    dense = tvision.vision_forward(tp["visual"], TCFG.vision, torch.from_numpy(px),
                                   tvision.get_vision_plan(grid, TCFG.vision))
    monkeypatch.setattr(jvision, "FLASH_FULL_ATTN_MIN_SEQ", 16)
    monkeypatch.setattr(tvision, "FLASH_FULL_ATTN_MIN_SEQ", 16)
    called = []
    monkeypatch.setattr(tvision, "vit_full_attention",
                        lambda *a: called.append(1) or segment_flash_attention(*a))
    segment_flash_attention.launches = 0
    want = jvision.vision_forward(jp["visual"], VCFG, jnp.asarray(px),
                                  jvision.get_vision_plan(grid, VCFG))
    got = tvision.vision_forward(tp["visual"], TCFG.vision, torch.from_numpy(px),
                                 tvision.get_vision_plan(grid, TCFG.vision))
    assert called == [1] and segment_flash_attention.launches == 0
    assert err_ratio(got, want) < TOL
    assert err_ratio(got, dense) < TOL


def test_window_flash_branch_names_kernel_f(weights, monkeypatch):
    _, tp = weights
    grid = GRIDS["one_image"]
    monkeypatch.setattr(tvision, "WINDOW_FLASH_MIN_SEQ", 0)
    monkeypatch.setattr(tvision, "WINDOW_FLASH_MIN_WIN_LEN", 16)
    with pytest.raises(NotImplementedError, match="kernel F"):
        tvision.vision_forward(tp["visual"], TCFG.vision,
                               torch.zeros((64, in_feat(VCFG))),
                               tvision.get_vision_plan(grid, TCFG.vision))
    with pytest.raises(NotImplementedError, match="kernel_q4f"):
        tvision.vision_block_forward(
            {**tp["visual"]["blocks"][0], "qkv": {"kernel_q4f": None}}, TCFG.vision,
            torch.zeros((64, 32)), tvision.get_vision_plan(grid, TCFG.vision), False,
            tvision.plan_tensors(tvision.get_vision_plan(grid, TCFG.vision), "cpu"))


def test_init_vision_params_has_the_jax_tree():
    want = init_vision_params(jax.random.PRNGKey(0), VCFG, jnp.float32)
    got = t_init_vision_params(TCFG.vision, torch.Generator().manual_seed(0), "cpu",
                               torch.float32)
    paths = lambda tree: [(jax.tree_util.keystr(p), tuple(x.shape))
                          for p, x in jax.tree_util.tree_leaves_with_path(tree)]
    assert paths(got) == paths(want)


def test_scatter_vision_embeds_exact():
    rng = np.random.RandomState(1)
    emb = rng.standard_normal((2, 9, 6)).astype(np.float32)
    mask = np.zeros((2, 9), bool)
    mask[0, 2:5] = mask[1, 0] = mask[1, 6:8] = True
    vis = rng.standard_normal((int(mask.sum()), 6)).astype(np.float32)
    want = jscatter(jnp.asarray(emb), jnp.asarray(vis), jnp.asarray(mask))
    got = scatter_vision_embeds(*map(torch.from_numpy, (emb, vis, mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[mask], vis)


def _mm_prompt(rng):
    """text, an image of 1x4x8 patches (8 tokens), text, a video of 2x4x4
    patches (8 tokens), text."""
    txt = lambda n: rng.randint(0, 400, n)
    ids = np.concatenate([
        txt(3), [CFG.vision_start_token_id], [CFG.image_token_id] * 8,
        [CFG.vision_end_token_id], txt(4), [CFG.vision_start_token_id],
        [CFG.video_token_id] * 8, [CFG.vision_end_token_id], txt(2)])[None]
    px = rng.standard_normal((32, in_feat(VCFG))).astype(np.float32)
    pv = rng.standard_normal((32, in_feat(VCFG))).astype(np.float32)
    return ids, px, ((1, 4, 8),), pv, ((2, 4, 4),)


def test_multimodal_forward_matches_jax(weights):
    jp, tp = weights
    ids, px, grid, pv, vgrid = _mm_prompt(np.random.RandomState(2))
    pos, _ = jrope_index(CFG, ids, np.array(grid), np.array(vgrid), [1.0])
    js = jstate.init_decoder_state(CFG.text, 1, jnp.float32)
    ts = init_decoder_state(TCFG.text, 1, torch.float32, "cpu")
    want, js = jforward(jp, CFG, jnp.asarray(ids), jnp.asarray(pos), js,
                        pixel_values=jnp.asarray(px), grid_thw=grid,
                        pixel_values_videos=jnp.asarray(pv), video_grid_thw=vgrid)
    got, ts = forward(tp, TCFG, torch.as_tensor(ids), torch.as_tensor(pos), ts,
                      pixel_values=torch.from_numpy(px), grid_thw=grid,
                      pixel_values_videos=torch.from_numpy(pv), video_grid_thw=vgrid)
    assert got.shape == want.shape
    assert err_ratio(got, want) < TOL
    for key in ("swa_k", "swa_v", "delta_h", "conv_q", "conv_k", "conv_v"):
        assert err_ratio(ts[key], js[key]) < TOL, key
    assert ts["cum_len"] == int(js["cum_len"]) == ids.shape[1]


def test_generator_multimodal_tokens_identical(weights):
    jp, tp = weights
    ids, px, grid, pv, vgrid = _mm_prompt(np.random.RandomState(4))
    kw = dict(pixel_values=px, image_grid_thw=np.array(grid), pixel_values_videos=pv,
              video_grid_thw=np.array(vgrid), second_per_grid_ts=[1.0],
              max_new_tokens=6, eos_token_id=-1)
    want = JGenerator(jp, CFG, dtype=jnp.float32).generate(ids, **kw)
    got = Generator(tp, TCFG, device="cpu").generate(ids, **kw)
    assert got.shape == (1, 6)
    np.testing.assert_array_equal(got, want)


def test_patchify_and_normalize_match_jax():
    rng = np.random.RandomState(6)
    raw = rng.randint(0, 256, (3, 8, 12, 3)).astype(np.uint8)  # odd T: last frame repeats
    np.testing.assert_array_equal(tproc.normalize(raw), jproc.normalize(raw))
    want, wgrid = jproc.patchify(jproc.normalize(raw), 2, 2, 2)
    got, ggrid = tproc.patchify(tproc.normalize(raw), 2, 2, 2)
    assert ggrid == wgrid == (2, 4, 6)
    np.testing.assert_array_equal(got, want)
    dev = tproc.patchify_device(torch.from_numpy(raw), 2, 2, 2)
    jdev = jproc.patchify_device(jnp.asarray(raw), 2, 2, 2)
    assert dev.shape == want.shape
    assert err_ratio(dev, jdev) < 1e-6 and err_ratio(dev, want) < 1e-6
