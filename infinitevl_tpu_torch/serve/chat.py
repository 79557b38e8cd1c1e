"""High-level chat engine (torch port of infinitevl_tpu/serve/chat.py):
multimodal chat / stream_chat over template-rendered messages, with image
and video inputs preprocessed through the data pipeline. One generation is
in flight at a time: every call into the generator holds the model's lock,
so handler threads never meet on the card."""

from __future__ import annotations

import threading
from typing import Dict, Generator as Gen, List, Optional, Sequence

import numpy as np

from ..data.processing import InfiniteVLProcessor, IMAGE_PAD, VISION_END, VISION_START
from ..data.template import get_template
from ..generation import Generator


def decode_image_uri(uri: str) -> np.ndarray:
    """`data:image/...;base64,...` URI (or a bare base64 string) -> RGB
    uint8 array. Shared by the OpenAI API and the board chat tab; every
    malformed input (missing payload, bad base64, non-image bytes) raises
    ValueError so HTTP layers can return 400s uniformly."""
    import base64
    import binascii
    import io

    from PIL import Image

    try:
        b64 = uri.split(",", 1)[1] if uri.startswith("data:") else uri
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        return np.asarray(img.convert("RGB"))
    except (IndexError, binascii.Error, OSError) as e:
        raise ValueError(f"undecodable image data URI: {e}") from e


class ChatModel:
    """chat(messages, images=...) -> response text; stream_chat yields
    text deltas. Single in-flight generation (a lock)."""

    def __init__(
        self,
        generator: Generator,
        tokenizer,
        template: str = "qwen2_vl",
        draft_k: int = 0,
    ):
        self.generator = generator
        self.tokenizer = tokenizer
        self.template = get_template(template)
        # draft_k > 0 opt-in routes batch-1 requests (text AND multimodal;
        # greedy or sampled) through prompt-lookup speculative decoding
        # (speculative.py), lossless: greedy is token-for-token equal,
        # sampled has the same distribution via rejection sampling.
        self.draft_k = int(draft_k)
        # measured acceptance of the most recent speculative request
        # (speculative.SpecStats); None until the first spec-routed chat
        self.last_spec_stats = None
        self.processor = InfiniteVLProcessor(tokenizer, generator.cfg)
        self._lock = threading.Lock()

    def _prepare(
        self,
        messages: List[Dict[str, str]],
        images: Optional[Sequence[np.ndarray]] = None,
        videos: Optional[Sequence[np.ndarray]] = None,
        fps: float = 2.0,
        tools: Optional[Sequence[Dict]] = None,
    ):
        """Render the prompt; vision placeholders in message contents are
        `<image>` / `<video>` markers expanded to
        vision_start + pads + vision_end. `tools` render into the system
        turn like the text path (serve/api.py uses this for multimodal
        tool-call requests)."""
        rendered = []
        for m in messages:
            c = m["content"]
            c = c.replace("<image>", VISION_START + IMAGE_PAD + VISION_END)
            c = c.replace("<video>", VISION_START + "<|video_pad|>" + VISION_END)
            rendered.append({"role": m["role"], "content": c})
        prompt = self.template.render_prompt(
            rendered, add_generation_prompt=True, tools=tools
        )
        return self.processor(prompt, images=images, videos=videos, fps=fps)

    def chat(
        self,
        messages: List[Dict[str, str]],
        images: Optional[Sequence[np.ndarray]] = None,
        videos: Optional[Sequence[np.ndarray]] = None,
        max_new_tokens: int = 512,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        seed: int = 0,
        num_beams: int = 1,
        length_penalty: float = 1.0,
        num_return_sequences: int = 1,
    ):  # -> str, or List[str] when num_return_sequences > 1
        out = self._prepare(messages, images, videos)
        if num_return_sequences > 1:
            # n > 1 completions force sampling (temperature defaults to
            # 1.0). Returns List[str].
            if num_beams > 1:
                raise ValueError(
                    "num_return_sequences > 1 is sampled; it does not "
                    "compose with beam search here"
                )
            n = int(num_return_sequences)
            if temperature == 0.0:
                temperature = 1.0
            if out.pixel_values is None and out.pixel_values_videos is None:
                # text-only: one batched decode over the tiled prompt (rows
                # sample independently and share the weight read)
                with self._lock:
                    toks = self.generator.generate(
                        np.repeat(out.input_ids, n, axis=0),
                        max_new_tokens=max_new_tokens,
                        temperature=temperature,
                        top_k=top_k,
                        top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        seed=seed,
                    )
                eos = self.generator.cfg.eos_token_id
                texts = []
                for b in range(n):
                    row = np.asarray(toks[b])
                    stop = np.where(row == eos)[0]
                    if stop.size:  # per-row EOS; later columns are padding
                        row = row[: stop[0] + 1]
                    texts.append(
                        self.tokenizer.decode(row, skip_special_tokens=True)
                    )
                return texts
            texts = []
            with self._lock:
                for i in range(n):  # multimodal: distinct seeds per sample
                    toks = self.generator.generate(
                        out.input_ids,
                        pixel_values=out.pixel_values,
                        image_grid_thw=out.image_grid_thw,
                        pixel_values_videos=out.pixel_values_videos,
                        video_grid_thw=out.video_grid_thw,
                        second_per_grid_ts=out.second_per_grid_ts,
                        max_new_tokens=max_new_tokens,
                        temperature=temperature,
                        top_k=top_k,
                        top_p=top_p,
                        repetition_penalty=repetition_penalty,
                        seed=seed + i,
                    )
                    texts.append(
                        self.tokenizer.decode(
                            toks[0], skip_special_tokens=True
                        )
                    )
            return texts
        if num_beams > 1:
            # beam search: greedy scoring, text-only (beam.py)
            if temperature != 0.0 or repetition_penalty != 1.0:
                raise ValueError(
                    "num_beams > 1 is greedy beam search; unset "
                    "temperature/repetition_penalty (HF ignores sampling "
                    "knobs under beams — we refuse them loudly instead)"
                )
            if out.pixel_values is not None or out.pixel_values_videos is not None:
                raise ValueError(
                    "num_beams > 1 is text-only; multimodal prompts "
                    "generate greedily (see beam.py docstring)"
                )
            with self._lock:
                tokens = self.generator.generate_beam(
                    out.input_ids, num_beams=num_beams,
                    max_new_tokens=max_new_tokens,
                    length_penalty=length_penalty,
                )
            return self.tokenizer.decode(tokens[0], skip_special_tokens=True)
        spec_ok = (
            self.draft_k > 0
            and repetition_penalty == 1.0
            and out.input_ids.shape[0] == 1
        )
        if spec_ok:
            from ..speculative import SpecStats

            stats = SpecStats()
            mm = dict(
                pixel_values=out.pixel_values,
                image_grid_thw=out.image_grid_thw,
                pixel_values_videos=out.pixel_values_videos,
                video_grid_thw=out.video_grid_thw,
                second_per_grid_ts=out.second_per_grid_ts,
            )
            with self._lock:
                if temperature == 0.0:
                    tokens = self.generator.generate_speculative(
                        out.input_ids,
                        max_new_tokens=max_new_tokens,
                        draft_k=self.draft_k,
                        stats=stats,
                        **mm,
                    )
                else:
                    # sampled requests: lossless rejection-sampled
                    # speculation — same token distribution as plain
                    # sampling (speculative.generate_speculative_sampled)
                    tokens = self.generator.generate_speculative_sampled(
                        out.input_ids,
                        max_new_tokens=max_new_tokens,
                        draft_k=self.draft_k,
                        temperature=temperature,
                        top_k=top_k,
                        top_p=top_p,
                        seed=seed,
                        stats=stats,
                        **mm,
                    )
                self.last_spec_stats = stats
            return self.tokenizer.decode(tokens[0], skip_special_tokens=True)
        with self._lock:
            tokens = self.generator.generate(
                out.input_ids,
                pixel_values=out.pixel_values,
                image_grid_thw=out.image_grid_thw,
                pixel_values_videos=out.pixel_values_videos,
                video_grid_thw=out.video_grid_thw,
                second_per_grid_ts=out.second_per_grid_ts,
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                repetition_penalty=repetition_penalty,
                seed=seed,
            )
        return self.tokenizer.decode(tokens[0], skip_special_tokens=True)

    def stream_chat(
        self,
        messages,
        images: Optional[Sequence[np.ndarray]] = None,
        videos: Optional[Sequence[np.ndarray]] = None,
        max_new_tokens: int = 512,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        seed: int = 0,
    ) -> Gen[str, None, None]:
        """TRUE streaming: yields text deltas as each decode chunk lands
        (generate_stream), not after generation completes."""
        out = self._prepare(messages, images, videos)
        eos = self.generator.cfg.eos_token_id
        with self._lock:
            toks = []
            prev = ""
            done = False
            for chunk in self.generator.generate_stream(
                out.input_ids,
                pixel_values=out.pixel_values,
                image_grid_thw=out.image_grid_thw,
                pixel_values_videos=out.pixel_values_videos,
                video_grid_thw=out.video_grid_thw,
                second_per_grid_ts=out.second_per_grid_ts,
                max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=top_k,
                top_p=top_p,
                repetition_penalty=repetition_penalty,
                seed=seed,
            ):
                for t in chunk[0]:
                    if int(t) == eos:
                        done = True
                        break
                    toks.append(int(t))
                text = self.tokenizer.decode(toks, skip_special_tokens=True)
                delta, prev = text[len(prev):], text
                if delta:
                    yield delta
                if done:
                    return
