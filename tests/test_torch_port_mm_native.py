"""The port's paligemma / gemma3 mm_plugin and its native host
preprocessing against the JAX package's, on the CPU.

- `encode_supervised_mm` with template paligemma and gemma3 on the image
  rows of data/mllm_demo.json: ids and labels equal to JAX's, the family's
  SigLIP pixels [N, 3, S, S] within 1e-6; videos and a placeholder count
  that does not match raise JAX's ValueError; another family's template
  raises JAX's message;
- `native.preprocess_frame` bit-equal to JAX's `native.preprocess_frame`
  on the same frames (both built from the same C++ source with the same
  flags), bilinear and bicubic, and `FramePipeline` returning each frame's
  result by its ticket, tickets in submission order; the library lands in
  `infinitevl_tpu_torch/_build/`."""

import numpy as np
import pytest

import infinitevl_tpu.data.loader as jloader
import infinitevl_tpu_torch.data.loader as tloader
from infinitevl_tpu import native as jnative
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu_torch import native as tnative
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

DATA_DIR = "data"


def _image_rows():
    registry = tloader.load_dataset_info(f"{DATA_DIR}/dataset_info.json")
    raw = tloader.load_examples(registry["mllm_demo"], DATA_DIR)
    return [ex for ex in raw if not ex.get("videos")]


@pytest.mark.parametrize("template,size", [("paligemma", 224), ("gemma3", 896)])
def test_family_plugin_encoding_matches_jax(template, size):
    cfg = tiny_config()
    rows = _image_rows()
    want = jloader.encode_supervised_mm(rows, jloader.SimpleTokenizer(), cfg, template=template,
                                        cutoff_len=1024, dataset_dir=DATA_DIR)
    got = tloader.encode_supervised_mm(rows, tloader.SimpleTokenizer(), to_port_config(cfg),
                                       template=template, cutoff_len=1024,
                                       dataset_dir=DATA_DIR)
    assert len(got) == len(want) == len(rows)
    n_img = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert (g["pixel_values"] is None) == (w["pixel_values"] is None)
        if w["pixel_values"] is not None:
            assert g["pixel_values"].shape == w["pixel_values"].shape
            assert g["pixel_values"].shape[1:] == (3, size, size)
            assert g["pixel_values"].dtype == np.float32
            assert np.abs(g["pixel_values"] - w["pixel_values"]).max() <= 1e-6
            n_img += g["pixel_values"].shape[0]
        for k in ("image_grid_thw", "pixel_values_videos", "video_grid_thw"):
            assert g[k] is None
    assert n_img > 0


def test_family_plugin_guards_match_jax():
    """Videos and a placeholder / image count mismatch raise JAX's
    ValueError; a family without a plugin raises JAX's message."""
    cfg = to_port_config(tiny_config())
    tok = tloader.SimpleTokenizer()
    video = [{"messages": [{"role": "user", "content": "hi"},
                           {"role": "assistant", "content": "ok"}],
              "videos": ["images/clip0.npy"]}]
    with pytest.raises(ValueError, match="video inputs are not supported"):
        tloader.encode_supervised_mm(video, tok, cfg, template="gemma3", cutoff_len=512,
                                     dataset_dir=DATA_DIR)
    bare = [{"messages": [{"role": "user", "content": "no placeholder"},
                          {"role": "assistant", "content": "ok"}],
             "images": ["images/red_square.png"]}]
    with pytest.raises(ValueError, match="0 <image> placeholders but 1 images"):
        tloader.encode_supervised_mm(bare, tok, cfg, template="paligemma", cutoff_len=1024,
                                     dataset_dir=DATA_DIR)
    rows = _image_rows()[:1]
    with pytest.raises(ValueError) as want:
        jloader.encode_supervised_mm(rows, jloader.SimpleTokenizer(), tiny_config(),
                                     template="llava", cutoff_len=1024, dataset_dir=DATA_DIR)
    with pytest.raises(ValueError) as got:
        tloader.encode_supervised_mm(rows, tok, cfg, template="llava", cutoff_len=1024,
                                     dataset_dir=DATA_DIR)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def built():
    if not jnative.available():
        pytest.skip("no C++ toolchain")
    assert tnative.available()
    return tnative.library_path()


def test_library_builds_under_the_build_dir(built):
    assert built.parent.name == "_build" and built.parent.parent.name == "infinitevl_tpu_torch"
    assert built.exists()


@pytest.mark.parametrize("bicubic", [False, True], ids=["bilinear", "bicubic"])
def test_preprocess_frame_bit_equal_to_jax(built, bicubic):
    rng = np.random.RandomState(0)
    for shape, out_hw, tps in (((100, 130, 3), (56, 56), 2), ((90, 120, 3), (56, 84), 1),
                               ((448, 448, 3), (448, 448), 2)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        want = jnative.preprocess_frame(img, out_hw, 14, tps, 2, bicubic=bicubic)
        got = tnative.preprocess_frame(img, out_hw, 14, tps, 2, bicubic=bicubic)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_frame_pipeline_returns_each_frame_by_ticket_in_order(built):
    rng = np.random.RandomState(3)
    imgs = [(rng.rand(64 + 8 * i, 64, 3) * 255).astype(np.uint8) for i in range(6)]
    pipe = tnative.FramePipeline(workers=3, patch_size=14, temporal_patch_size=2,
                                 merge_size=2, bicubic=False)
    try:
        tickets = [pipe.submit(im, (56, 56)) for im in imgs]
        assert tickets == sorted(tickets) and len(set(tickets)) == len(imgs)
        outs = [pipe.collect(t, (56, 56)) for t in tickets]
    finally:
        pipe.close()
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out, jnative.preprocess_frame(im, (56, 56), 14, 2, 2,
                                                                    bicubic=False))
