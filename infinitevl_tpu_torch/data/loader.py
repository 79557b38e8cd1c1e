"""Dataset loading, supervised encoding and packing, and tokenizer
selection (torch port of infinitevl_tpu/data/loader.py; numpy only).

Datasets are listed in a `dataset_info.json` (alpaca and sharegpt
formatting, column and tag overrides), converted to role/content messages,
encoded through a chat template into (input_ids, labels) with prompt
tokens masked to IGNORE_INDEX, and optionally packed into fixed-length
rows with per-token segment ids. Multimodal examples expand their
<image> / <video> placeholders into vision pad-token runs and carry their
flattened patches and grids. Preference data is encoded as chosen /
rejected pairs (rm, dpo) or as rows tagged desirable or not (kto).

Streaming datasets (`streaming: true`) go through the lazy twins
`iter_examples`, `stream_mixed_examples` and `encode_supervised_stream`:
nothing is materialized, and train/trainer.collate_stream shuffles and
packs them through a bounded reservoir."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .template import IGNORE_INDEX, Template, get_template


@dataclasses.dataclass
class DatasetAttr:
    name: str
    file_name: Optional[str] = None
    formatting: str = "alpaca"  # alpaca | sharegpt
    columns: Optional[Dict[str, str]] = None
    split: str = "train"
    ranking: bool = False  # preference pairs (chosen/rejected)
    # sharegpt tag overrides (reference data/parser.py:68-80): custom key
    # names for the role/content fields and custom role spellings
    tags: Optional[Dict[str, str]] = None
    folder: Optional[str] = None  # subdirectory under dataset_dir
    num_samples: Optional[int] = None  # cap rows at load time
    # hub-style loading through the `datasets` library (reference
    # data/loader.py:123-137: load_dataset(path, name, split, streaming)).
    # `hf_hub_url` is passed as load_dataset's `path` — a hub repo id, a
    # local dataset directory, or a format name; `subset` is its `name`.
    hf_hub_url: Optional[str] = None
    subset: Optional[str] = None
    # ModelScope-only entries (reference dataset_info.json `ms_hub_url`,
    # e.g. deepctrl): kept in the registry for inventory parity but there
    # is no ModelScope loading path on this build — selecting one raises a
    # clear error instead of a misleading HF-hub 404.
    ms_hub_url: Optional[str] = None


def load_dataset_info(path: str) -> Dict[str, DatasetAttr]:
    with open(path) as f:
        info = json.load(f)
    out = {}
    for name, meta in info.items():
        if name.startswith("_"):  # provenance/comment keys, not datasets
            continue
        out[name] = DatasetAttr(
            name=name,
            file_name=meta.get("file_name"),
            formatting=meta.get("formatting", "alpaca"),
            columns=meta.get("columns"),
            split=meta.get("split", "train"),
            ranking=meta.get("ranking", False),
            tags=meta.get("tags"),
            folder=meta.get("folder"),
            num_samples=meta.get("num_samples"),
            hf_hub_url=meta.get("hf_hub_url"),
            ms_hub_url=meta.get("ms_hub_url"),
            subset=meta.get("subset"),
        )
    return out


def _pref_value(v) -> str:
    """Preference responses may be raw strings or sharegpt turn dicts."""
    if isinstance(v, dict):
        return v.get("value", v.get("content", ""))
    return v


def convert_alpaca(ex: Dict[str, Any], columns: Optional[Dict[str, str]] = None):
    """{'instruction', 'input', 'output'[, 'system','history']} -> messages.
    Ranking rows carry 'chosen'/'rejected' instead of 'output'; KTO rows add
    'kto_tag' (reference data/converter.py preference handling)."""
    c = columns or {}
    prompt = ex.get(c.get("prompt", "instruction"), "") or ""
    query = ex.get(c.get("query", "input"), "") or ""
    response = ex.get(c.get("response", "output"), "") or ""
    system = ex.get(c.get("system", "system"), None)
    msgs: List[Dict[str, str]] = []
    if system:
        msgs.append({"role": "system", "content": system})
    for h in ex.get(c.get("history", "history"), []) or []:
        msgs.append({"role": "user", "content": h[0]})
        msgs.append({"role": "assistant", "content": h[1]})
    user = prompt + ("\n" + query if query else "")
    msgs.append({"role": "user", "content": user})
    out = {"images": ex.get("images"), "videos": ex.get("videos")}
    if "chosen" in ex:
        out["chosen"] = _pref_value(ex["chosen"])
        out["rejected"] = _pref_value(ex.get("rejected", ""))
    else:
        msgs.append({"role": "assistant", "content": response})
    if "kto_tag" in ex:
        out["kto_tag"] = bool(ex["kto_tag"])
    out["messages"] = msgs
    return out


def convert_sharegpt(
    ex: Dict[str, Any],
    columns: Optional[Dict[str, str]] = None,
    tags: Optional[Dict[str, str]] = None,
):
    """{'conversations': [{'from': human|gpt|system, 'value': ...}]}.
    `tags` renames the role/content keys and the role spellings
    (reference data/parser.py:68-80: role_tag/content_tag/user_tag/
    assistant_tag/observation_tag/function_tag/system_tag)."""
    c = columns or {}
    t = tags or {}
    role_map = {"human": "user", "gpt": "assistant", "system": "system",
                "user": "user", "assistant": "assistant",
                "observation": "user", "function_call": "assistant"}
    for tag, role in (
        ("user_tag", "user"), ("assistant_tag", "assistant"),
        ("observation_tag", "user"), ("function_tag", "assistant"),
        ("system_tag", "system"),
    ):
        if t.get(tag):
            role_map[t[tag]] = role
    role_key = t.get("role_tag", "from")
    content_key = t.get("content_tag", "value")
    msgs = []
    conv_key = c.get("messages", "conversations")
    for turn in ex[conv_key]:
        role = role_map[turn.get(role_key, turn.get("role"))]
        msgs.append(
            {"role": role,
             "content": turn.get(content_key, turn.get("content", ""))}
        )
    if ex.get(c.get("system", "system")):
        msgs.insert(0, {"role": "system", "content": ex[c.get("system", "system")]})
    out = {
        "messages": msgs,
        "images": ex.get("images"),
        "videos": ex.get("videos"),
    }
    if "chosen" in ex:
        out["chosen"] = _pref_value(ex["chosen"])
        out["rejected"] = _pref_value(ex.get("rejected", ""))
    if "kto_tag" in ex:
        out["kto_tag"] = bool(ex["kto_tag"])
    return out


def _convert_row(attr: DatasetAttr, row: Dict[str, Any]) -> Dict[str, Any]:
    if attr.formatting == "alpaca":
        return convert_alpaca(row, attr.columns)
    return convert_sharegpt(row, attr.columns, attr.tags)


def _iter_raw_rows(
    attr: DatasetAttr, data_dir: str, streaming: bool = False
) -> Iterable[Dict[str, Any]]:
    """Raw (unconverted) rows for one registry entry.

    - `hf_hub_url` set: routed through `datasets.load_dataset` (reference
      data/loader.py:123-137) — hub repo ids, local dataset dirs, and
      format names all resolve there; `streaming=True` yields an
      IterableDataset so nothing materializes.
    - otherwise: local file(s); `file_name` may be a glob pattern (shards
      load in sorted order) and .jsonl files stream line-by-line.
    """
    if attr.ms_hub_url and not attr.hf_hub_url:
        raise ValueError(
            f"dataset {attr.name!r} is registered only on ModelScope "
            f"({attr.ms_hub_url}); this build has no ms_hub loading path — "
            "download it locally and point a file_name entry at it"
        )
    if attr.hf_hub_url:
        from datasets import load_dataset as _hf_load

        yield from _hf_load(
            path=attr.hf_hub_url,
            name=attr.subset,
            split=attr.split,
            streaming=streaming,
        )
        return
    import glob as _glob

    base = os.path.join(data_dir, attr.folder) if attr.folder else data_dir
    pattern = os.path.join(base, attr.file_name)
    paths = sorted(_glob.glob(pattern)) if _glob.has_magic(pattern) else [pattern]
    if not paths:
        raise FileNotFoundError(f"no files match {pattern}")
    for path in paths:
        with open(path) as f:
            if path.endswith(".jsonl"):
                for line in f:
                    if line.strip():
                        yield json.loads(line)
            else:
                yield from json.load(f)


def iter_examples(
    attr: DatasetAttr, data_dir: str = "data"
) -> Iterable[Dict[str, Any]]:
    """Lazily yield converted examples for one registry entry (streaming
    mode: nothing is materialized; per-attr num_samples is ignored, matching
    the reference's streaming semantics)."""
    for row in _iter_raw_rows(attr, data_dir, streaming=True):
        yield _convert_row(attr, row)


def load_examples(
    attr: DatasetAttr, data_dir: str = "data"
) -> List[Dict[str, Any]]:
    """Load one registry entry fully into memory."""
    raw = list(_iter_raw_rows(attr, data_dir))
    if attr.num_samples is not None:
        raw = raw[: attr.num_samples]
    return [_convert_row(attr, ex) for ex in raw]


def load_mixed_examples(
    names: List[str],
    registry: Dict[str, DatasetAttr],
    data_dir: str = "data",
    mix_strategy: str = "concat",
    interleave_probs: Optional[List[float]] = None,
    seed: int = 42,
) -> List[Dict[str, Any]]:
    """Multi-dataset loading with the reference's mixing strategies
    (data/data_utils.py:49-74 merge_dataset):

    - concat: datasets back to back
    - interleave_under: sample by `interleave_probs` until ANY dataset is
      exhausted (datasets.interleave_datasets first_exhausted)
    - interleave_over: sample until ALL datasets are exhausted at least
      once; early-exhausted sets wrap around (all_exhausted)
    """
    import numpy as _np

    sets = [load_examples(registry[n], data_dir) for n in names]
    if len(sets) == 1 or mix_strategy == "concat":
        return [ex for s in sets for ex in s]
    if not mix_strategy.startswith("interleave"):
        raise ValueError(f"unknown mixing strategy {mix_strategy!r}")
    probs = interleave_probs or [1.0 / len(sets)] * len(sets)
    if len(probs) != len(sets):
        raise ValueError(
            f"interleave_probs has {len(probs)} entries for {len(sets)} datasets"
        )
    total = float(sum(probs))
    probs = [p / total for p in probs]
    rng = _np.random.RandomState(seed)
    cursors = [0] * len(sets)
    exhausted = [False] * len(sets)
    out: List[Dict[str, Any]] = []
    under = mix_strategy.endswith("under")
    while True:
        i = int(rng.choice(len(sets), p=probs))
        if cursors[i] >= len(sets[i]):
            exhausted[i] = True
            if under or all(exhausted):
                break
            cursors[i] = 0  # over-sampling wraps around (all_exhausted)
        out.append(sets[i][cursors[i]])
        cursors[i] += 1
    return out


def stream_mixed_examples(
    names: List[str],
    registry: Dict[str, DatasetAttr],
    data_dir: str = "data",
    mix_strategy: str = "concat",
    interleave_probs: Optional[List[float]] = None,
    seed: int = 42,
) -> Iterable[Dict[str, Any]]:
    """Lazy multi-dataset mixing: the strategies of load_mixed_examples over
    iterators, nothing materialized.

    - concat: sources chained back to back
    - interleave_under: sample by probs until ANY source is exhausted
    - interleave_over: sample until ALL sources have completed at least
      once; exhausted sources restart from the beginning
    """
    if len(names) == 1 or mix_strategy == "concat":
        for n in names:
            yield from iter_examples(registry[n], data_dir)
        return
    if not mix_strategy.startswith("interleave"):
        raise ValueError(f"unknown mixing strategy {mix_strategy!r}")
    probs = interleave_probs or [1.0 / len(names)] * len(names)
    if len(probs) != len(names):
        raise ValueError(
            f"interleave_probs has {len(probs)} entries for {len(names)} datasets"
        )
    total = float(sum(probs))
    probs = [p / total for p in probs]
    rng = np.random.RandomState(seed)
    iters = [iter_examples(registry[n], data_dir) for n in names]
    completed = [False] * len(names)
    under = mix_strategy.endswith("under")
    while True:
        i = int(rng.choice(len(names), p=probs))
        try:
            yield next(iters[i])
        except StopIteration:
            completed[i] = True
            if under or all(completed):
                return
            iters[i] = iter_examples(registry[names[i]], data_dir)
            try:
                yield next(iters[i])
            except StopIteration:  # empty dataset: nothing to wrap around
                return


def encode_supervised_stream(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    template: Template | str = "qwen2_vl",
    cutoff_len: int = 2048,
) -> Iterable[Dict[str, np.ndarray]]:
    """Lazy twin of encode_supervised for streaming mode. Multimodal
    examples raise: streaming is text-only (use the materialized path with
    bucketed resolutions)."""
    if isinstance(template, str):
        template = get_template(template)
    for ex in examples:
        if ex.get("images") or ex.get("videos"):
            raise ValueError(
                "streaming mode supports text-only datasets; multimodal "
                "training needs the materialized path (streaming: false)"
            )
        ids, labels = template.encode_turns(tokenizer, ex["messages"])
        yield {
            "input_ids": np.asarray(ids[:cutoff_len], np.int64),
            "labels": np.asarray(labels[:cutoff_len], np.int64),
        }


def encode_supervised(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    template: Template | str = "qwen2_vl",
    cutoff_len: int = 2048,
) -> List[Dict[str, np.ndarray]]:
    """Encode each example to {'input_ids', 'labels'} (truncated)."""
    if isinstance(template, str):
        template = get_template(template)
    out = []
    for ex in examples:
        ids, labels = template.encode_turns(tokenizer, ex["messages"])
        out.append(
            {
                "input_ids": np.asarray(ids[:cutoff_len], np.int64),
                "labels": np.asarray(labels[:cutoff_len], np.int64),
            }
        )
    return out


def encode_pairwise(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    template: Template | str = "qwen2_vl",
    cutoff_len: int = 2048,
) -> List[Dict[str, np.ndarray]]:
    """Preference pairs for rm/dpo: encode prompt+chosen and prompt+rejected
    through the chat template (the reference PairwiseDataCollator path,
    data/processor/pairwise.py). Each example needs messages ending with a
    user turn plus 'chosen'/'rejected' response strings."""
    if isinstance(template, str):
        template = get_template(template)
    out = []
    for ex in examples:
        if "chosen" not in ex:
            raise ValueError(
                "pairwise encoding needs 'chosen'/'rejected' responses; "
                "mark the dataset with \"ranking\": true and use a "
                "preference-format file"
            )
        enc = {}
        for side in ("chosen", "rejected"):
            msgs = list(ex["messages"]) + [
                {"role": "assistant", "content": ex[side]}
            ]
            ids, labels = template.encode_turns(tokenizer, msgs)
            enc[f"{side}_ids"] = np.asarray(ids[:cutoff_len], np.int64)
            enc[f"{side}_labels"] = np.asarray(labels[:cutoff_len], np.int64)
        out.append(enc)
    return out


def encode_kto(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    template: Template | str = "qwen2_vl",
    cutoff_len: int = 2048,
) -> List[Dict[str, np.ndarray]]:
    """Unpaired feedback for KTO: supervised encoding plus the per-example
    desirability tag (reference data/processor/feedback.py kto_tag)."""
    if isinstance(template, str):
        template = get_template(template)
    out = []
    for ex in examples:
        if "kto_tag" not in ex:
            raise ValueError("kto encoding needs a 'kto_tag' bool per example")
        ids, labels = template.encode_turns(tokenizer, ex["messages"])
        out.append(
            {
                "input_ids": np.asarray(ids[:cutoff_len], np.int64),
                "labels": np.asarray(labels[:cutoff_len], np.int64),
                "is_desirable": np.bool_(ex["kto_tag"]),
            }
        )
    return out


IMAGE_PLACEHOLDER = "<image>"


VIDEO_PLACEHOLDER = "<video>"


def load_media(path: str) -> np.ndarray:
    """Load an image ([H, W, C] uint8) or video clip ([T, H, W, C] uint8).
    Supports .npy arrays (fixtures / pre-decoded clips) and anything PIL can
    open; a directory is read as an ordered sequence of frame images."""
    if path.endswith(".npy"):
        return np.load(path)
    if os.path.isdir(path):
        frames = [load_media(os.path.join(path, f)) for f in sorted(os.listdir(path))]
        return np.stack(frames)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")


def load_video(
    path: str, max_decode_frames: int = 512
) -> Tuple[np.ndarray, Optional[float]]:
    """Decode a video clip -> ([T, H, W, C] uint8 RGB, source fps or None).

    Real containers decode through OpenCV (the reference samples frames with
    PyAV, mm_plugin.py:1129-1152; OpenCV is the decoder used here) with the
    container's fps read from the header so downstream fps-sampling
    (`sample_frames`) uses the true source rate. .npy / frame-directory
    fixtures return fps=None (caller falls back to its video_src_fps)."""
    if path.lower().endswith(VIDEO_EXTS):
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"cannot open video {path!r}")
        try:
            fps = float(cap.get(cv2.CAP_PROP_FPS)) or None
            frames = []
            while len(frames) < max_decode_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame[:, :, ::-1])  # BGR -> RGB
        finally:
            cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {path!r}")
        return np.ascontiguousarray(np.stack(frames)), fps
    return load_media(path), None


def _encode_supervised_family_mm(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    template: Template,
    plugin,  # mm_plugin.FamilyMMPlugin
    cutoff_len: int,
    dataset_dir: str,
) -> List[Dict[str, np.ndarray]]:
    """Supervised encoding under a non-Qwen family plugin (paligemma /
    gemma3; data/mm_plugin.py): fixed-count token expansion, fixed-resize
    SigLIP pixels [N, 3, S, S]. Mirrors reference PaliGemmaPlugin
    (mm_plugin.py:913 — placeholders stripped, image tokens PREPENDED with
    IGNORE labels) and Gemma3Plugin (:407 — placeholder -> boi + soft
    tokens + eoi in place). Videos raise (neither reference plugin takes
    them)."""
    out = []
    for ex in examples:
        if ex.get("videos"):
            raise ValueError(
                f"{plugin.name}: video inputs are not supported by this "
                f"family's mm_plugin (image-only; reference "
                f"mm_plugin.py:913/:407)"
            )
        image_paths = ex.get("images") or []
        pix = [
            plugin.preprocess_image(load_media(os.path.join(dataset_dir, p)))
            for p in image_paths
        ]
        messages = plugin.expand_messages(ex["messages"], len(image_paths))
        ids, labels = template.encode_turns(tokenizer, messages)
        pre_ids, _ = plugin.prefix_ids(tokenizer, len(image_paths))
        if pre_ids:
            ids = pre_ids + ids
            labels = [IGNORE_INDEX] * len(pre_ids) + labels
        if pix and len(ids) > cutoff_len:
            raise ValueError(
                f"multimodal example length {len(ids)} exceeds cutoff_len "
                f"{cutoff_len}; raise cutoff_len (image runs must not be "
                f"truncated)"
            )
        out.append(
            {
                "input_ids": np.asarray(ids[:cutoff_len], np.int64),
                "labels": np.asarray(labels[:cutoff_len], np.int64),
                # HF family layout [N, 3, S, S] — NOT InfiniteVL flat
                # patches; see mm_plugin.py module docstring
                "pixel_values": np.stack(pix) if pix else None,
                "image_grid_thw": None,
                "pixel_values_videos": None,
                "video_grid_thw": None,
                "second_per_grid_ts": None,
            }
        )
    return out


def encode_supervised_mm(
    examples: Iterable[Dict[str, Any]],
    tokenizer,
    cfg,  # InfiniteVLConfig (vision geometry + special-token ids)
    template: Template | str = "qwen2_vl",
    cutoff_len: int = 2048,
    dataset_dir: str = "data",
    min_pixels: int = 56 * 56,
    max_pixels: int = 14 * 14 * 4 * 1280,
    video_fps: float = 2.0,
    video_src_fps: float = 30.0,
    video_max_frames: int = 64,
    video_min_pixels: int = 128 * 28 * 28,
    video_max_pixels: int = 768 * 28 * 28,
) -> List[Dict[str, np.ndarray]]:
    """Multimodal supervised encoding: <image>/<video> placeholders in the
    message contents are expanded to <|vision_start|> + N pad tokens +
    <|vision_end|> (N = grid.prod()/merge^2), and each example carries its
    packed patch tensors. Mirrors the reference mm_plugin.process_messages +
    _get_mm_inputs (data/mm_plugin.py:1129-1291).

    Vision examples are never truncated — cutting through a pad-token run
    would break the feature/token count contract — so an over-long example
    raises instead."""
    from .processing import (
        IMAGE_PAD,
        VIDEO_PAD,
        VISION_END,
        VISION_START,
        preprocess_image,
        preprocess_video,
        sample_frames,
    )

    if isinstance(template, str):
        template = get_template(template)
    # The Qwen2VL vision token scheme (<|vision_start|> + grid/merge^2 pad
    # tokens + <|vision_end|>, the scheme InfiniteVL deploys) is the native
    # path. paligemma / gemma3 have minimal per-family plugins
    # (data/mm_plugin.py: fixed-count token expansion + fixed-resize SigLIP
    # pixels). Every other family's template is text-parity only: training
    # it on image data would emit token ids its checkpoints never saw, so
    # it is refused.
    from .mm_plugin import get_mm_plugin

    family_plugin = get_mm_plugin(template.name)
    if family_plugin is not None:
        return _encode_supervised_family_mm(examples, tokenizer, template, family_plugin,
                                            cutoff_len, dataset_dir)
    if template.name not in ("qwen2_vl", "qwen_text", "custom", "empty"):
        raise ValueError(
            f"multimodal encoding supports the Qwen2VL vision token scheme "
            f"(InfiniteVL's deployed processor) plus minimal "
            f"paligemma/gemma3 plugins; template {template.name!r} belongs "
            f"to a family whose mm_plugin is out of scope — use "
            f"template: qwen2_vl for vision data"
        )
    v = cfg.vision
    merge2 = v.spatial_merge_size**2
    out = []
    for ex in examples:
        image_paths = ex.get("images") or []
        video_paths = ex.get("videos") or []
        img_feats, img_grids = [], []
        for p in image_paths:
            flat, grid = preprocess_image(
                load_media(os.path.join(dataset_dir, p)),
                v.patch_size, v.temporal_patch_size, v.spatial_merge_size,
                min_pixels, max_pixels,
            )
            img_feats.append(flat)
            img_grids.append(grid)
        vid_feats, vid_grids, spgs = [], [], []
        for p in video_paths:
            raw, container_fps = load_video(os.path.join(dataset_dir, p))
            clip = sample_frames(
                raw,
                src_fps=container_fps or video_src_fps,
                target_fps=video_fps,
                max_frames=video_max_frames,
                temporal_patch_size=v.temporal_patch_size,
            )
            flat, grid, spg = preprocess_video(
                clip, video_fps, v.patch_size, v.temporal_patch_size,
                v.spatial_merge_size, video_min_pixels, video_max_pixels,
            )
            vid_feats.append(flat)
            vid_grids.append(grid)
            spgs.append(spg)

        # expand placeholders in message order, consuming grids in order
        img_i = vid_i = 0
        messages = []
        for m in ex["messages"]:
            content = m["content"]
            while IMAGE_PLACEHOLDER in content:
                if img_i >= len(img_grids):
                    raise ValueError(
                        f"more {IMAGE_PLACEHOLDER} placeholders than images"
                    )
                t, h, w = img_grids[img_i]
                n = t * h * w // merge2
                content = content.replace(
                    IMAGE_PLACEHOLDER, VISION_START + IMAGE_PAD * n + VISION_END, 1
                )
                img_i += 1
            while VIDEO_PLACEHOLDER in content:
                if vid_i >= len(vid_grids):
                    raise ValueError(
                        f"more {VIDEO_PLACEHOLDER} placeholders than videos"
                    )
                t, h, w = vid_grids[vid_i]
                n = t * h * w // merge2
                content = content.replace(
                    VIDEO_PLACEHOLDER, VISION_START + VIDEO_PAD * n + VISION_END, 1
                )
                vid_i += 1
            messages.append({"role": m["role"], "content": content})
        if img_i < len(img_grids) or vid_i < len(vid_grids):
            raise ValueError("more media files than placeholders in messages")

        ids, labels = template.encode_turns(tokenizer, messages)
        has_vision = bool(img_feats or vid_feats)
        if has_vision and len(ids) > cutoff_len:
            raise ValueError(
                f"multimodal example length {len(ids)} exceeds cutoff_len "
                f"{cutoff_len}; raise cutoff_len or shrink image_max_pixels"
            )
        out.append(
            {
                "input_ids": np.asarray(ids[:cutoff_len], np.int64),
                "labels": np.asarray(labels[:cutoff_len], np.int64),
                "pixel_values": np.concatenate(img_feats) if img_feats else None,
                "image_grid_thw": np.asarray(img_grids) if img_grids else None,
                "pixel_values_videos": (
                    np.concatenate(vid_feats) if vid_feats else None
                ),
                "video_grid_thw": np.asarray(vid_grids) if vid_grids else None,
                "second_per_grid_ts": spgs or None,
            }
        )
    return out


def greedy_knapsack(lengths: Sequence[int], capacity: int) -> List[List[int]]:
    """Pack example indices into bins of <= capacity total length
    (processor_utils.py:48-64 strategy: sort desc, first-fit)."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    bins: List[Tuple[int, List[int]]] = []  # (remaining, indices)
    for i in order:
        L = min(lengths[i], capacity)
        for bi, (rem, idxs) in enumerate(bins):
            if L <= rem:
                bins[bi] = (rem - L, idxs + [i])
                break
        else:
            bins.append((capacity - L, [i]))
    return [idxs for _, idxs in bins]


def pack_examples(
    encoded: Sequence[Dict[str, np.ndarray]],
    cutoff_len: int,
    pad_token_id: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """neat_packing: concat examples into cutoff_len rows with segment ids
    (1, 2, 3, ... per example, 0 = padding) so attention and the delta
    kernels can mask across boundaries."""
    lens = [len(e["input_ids"]) for e in encoded]
    packs = greedy_knapsack(lens, cutoff_len)
    out = []
    for idxs in packs:
        ids = np.full(cutoff_len, pad_token_id, np.int64)
        labels = np.full(cutoff_len, IGNORE_INDEX, np.int64)
        seg = np.zeros(cutoff_len, np.int32)
        off = 0
        for si, i in enumerate(idxs, start=1):
            e = encoded[i]
            L = min(len(e["input_ids"]), cutoff_len - off)
            ids[off : off + L] = e["input_ids"][:L]
            labels[off : off + L] = e["labels"][:L]
            seg[off : off + L] = si
            off += L
        out.append({"input_ids": ids, "labels": labels, "segment_ids": seg})
    return out


def shift_labels(labels: np.ndarray, pad: int = IGNORE_INDEX) -> np.ndarray:
    """Next-token alignment: label[t] supervises logits[t] for token t+1."""
    out = np.full_like(labels, pad)
    out[..., :-1] = labels[..., 1:]
    return out


class SimpleTokenizer:
    """Word-level tokenizer for tests and offline smoke runs (real
    deployments pass the HF Qwen2 tokenizer). Special tokens of the form
    <|...|> — and bare <snake_case> family specials like <image> /
    <image_soft_token> (mm_plugin families concatenate them without
    whitespace) — are split out even without surrounding whitespace."""

    _SPECIAL = re.compile(r"(<\|[^|>]+\|>|<[a-z][a-z_]*>)")

    def __init__(self, vocab: Optional[Dict[str, int]] = None, unk: int = 1,
                 config=None):
        self.vocab = dict(vocab or {})
        self.unk = unk
        self.eos_token_id = 2
        if config is not None:
            # pin vision control tokens to the config's ids so multimodal
            # masks line up in offline smoke runs
            self.vocab["<|image_pad|>"] = config.image_token_id
            self.vocab["<|video_pad|>"] = config.video_token_id
            self.vocab["<|vision_start|>"] = config.vision_start_token_id
            self.vocab["<|vision_end|>"] = config.vision_end_token_id
            self.eos_token_id = config.eos_token_id

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = []
        for piece in self._SPECIAL.split(text.replace("\n", " \\n ")):
            words = [piece] if self._SPECIAL.fullmatch(piece) else piece.split()
            for w in words:
                if w not in self.vocab:
                    self.vocab[w] = len(self.vocab) + 10
                ids.append(self.vocab[w])
        return ids

    def decode(self, ids, skip_special_tokens=True):
        rev = {v: k for k, v in self.vocab.items()}
        return " ".join(rev.get(int(i), "<unk>") for i in ids)


def resolve_tokenizer(args=None, cfg=None, tokenizer=None):
    """Central tokenizer selection: an explicit tokenizer wins; else HF
    tokenizer files (tokenizer_path or model_name_or_path) whenever
    present; SimpleTokenizer only as the offline fallback."""
    if tokenizer is not None:
        return tokenizer
    path = None
    if args is not None:
        path = getattr(args.model, "tokenizer_path", None) or getattr(
            args.model, "model_name_or_path", None
        )
    if path:
        import os

        marker_files = (
            "tokenizer.json", "tokenizer_config.json", "vocab.json",
            "tokenizer.model",
        )
        if any(os.path.exists(os.path.join(path, f)) for f in marker_files):
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(path)
    return SimpleTokenizer(config=cfg)
