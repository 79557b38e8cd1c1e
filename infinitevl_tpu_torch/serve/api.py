"""OpenAI-compatible chat-completions API server (torch port of
infinitevl_tpu/serve/api.py): GET /v1/models, POST /v1/chat/completions
(+ SSE streaming), POST /v1/score/evaluation, optional API-key auth. Built
on the stdlib http.server with a threading server. The handler threads
share one CUDA context and one model, so every call into the generator
runs under the backend's lock: one generation is on the card at a time."""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.template import get_template


def _parse_content_parts(messages):
    """OpenAI content-parts -> plain-text contents with `<image>` markers
    plus decoded images. Images arrive as `data:` base64 URIs or raw base64
    strings; remote http(s) URLs error with a clear message: fetching
    arbitrary URLs from a server is an SSRF hole.

    All malformed-input failures (bad base64, non-image bytes, missing
    data-URI payload) surface as ValueError so the HTTP layer can map
    every caller error to a 400."""
    from .chat import decode_image_uri

    out: List[Dict[str, Any]] = []
    images: List[np.ndarray] = []
    for m in messages:
        c = m.get("content")
        if not isinstance(c, list):
            out.append(m)
            continue
        buf = []
        for part in c:
            t = part.get("type")
            if t == "text":
                buf.append(part.get("text", ""))
            elif t == "image_url":
                url = part.get("image_url", {})
                if isinstance(url, dict):
                    url = url.get("url", "")
                if url.startswith(("http://", "https://")):
                    raise ValueError(
                        "remote image URLs are not fetched; "
                        "send the image as a data:image/...;base64,... URI"
                    )
                images.append(decode_image_uri(url))
                buf.append("<image>")
            else:
                raise ValueError(f"unsupported content part type {t!r}")
        out.append({**m, "content": "".join(buf)})
    return out, images


def _normalize_stop(stop) -> List[str]:
    """OpenAI `stop`: a string or up to 4 strings (protocol.py:104)."""
    if stop is None:
        return []
    if isinstance(stop, str):
        return [stop] if stop else []
    if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
        raise ValueError("stop must be a string or a list of strings")
    return [s for s in stop if s]


def _truncate_at_stop(text: str, stops: List[str]):
    """Cut at the EARLIEST stop-sequence occurrence; the stop text itself is
    excluded from the output (OpenAI semantics). Returns (text, hit)."""
    cut = -1
    for s in stops:
        i = text.find(s)
        if i != -1 and (cut == -1 or i < cut):
            cut = i
    return (text[:cut], True) if cut != -1 else (text, False)


class ChatBackend:
    """Adapter between the HTTP layer and a Generator + tokenizer."""

    def __init__(self, generator, tokenizer, template: str = "qwen2_vl",
                 model_name: str = "infinitevl-torch", draft_k: int = 0):
        self.generator = generator
        self.tokenizer = tokenizer
        self.template = get_template(template)
        self.model_name = model_name
        # draft_k > 0: greedy text-only completions go through lossless
        # prompt-lookup speculative decoding (speculative.py)
        self.draft_k = int(draft_k)
        self.lock = threading.Lock()
        self._mm_lock = threading.Lock()

    def _mm_model(self):
        """Lazy ChatModel sharing this backend's generator/tokenizer/
        template — the processor-backed preparation path for multimodal
        requests (built on first image request only; text-only serving
        never touches the vision processor). Init is guarded: the
        threading server can race two first image requests here."""
        with self._mm_lock:
            return self._mm_model_locked()

    def _mm_model_locked(self):
        if not hasattr(self, "_chat_model"):
            from ..data.processing import InfiniteVLProcessor
            from .chat import ChatModel

            cm = ChatModel.__new__(ChatModel)
            cm.generator = self.generator
            cm.tokenizer = self.tokenizer
            cm.template = self.template
            cm.processor = InfiniteVLProcessor(self.tokenizer, self.generator.cfg)
            cm.draft_k = self.draft_k
            cm._lock = threading.Lock()
            self._chat_model = cm
        return self._chat_model

    def _stop_and_finish(self, texts, rows, stops):
        """Apply stop-sequence truncation in place; per-text finish_reason:
        "stop" when the row hit EOS or a stop string, else "length"
        (max_tokens exhausted), the OpenAI finish mapping."""
        eos = self.generator.cfg.eos_token_id
        finishes = []
        for i, t in enumerate(texts):
            t2, hit = _truncate_at_stop(t, stops)
            texts[i] = t2
            eos_hit = bool((np.asarray(rows[i]) == eos).any())
            finishes.append("stop" if (hit or eos_hit) else "length")
        return finishes

    def complete(
        self,
        messages: List[Dict[str, str]],
        max_tokens: int = 512,
        temperature: float = 0.0,
        top_p: float = 1.0,
        tools: Optional[List[Dict[str, Any]]] = None,
        n: int = 1,
        stop=None,
        do_sample: Optional[bool] = None,
    ) -> Dict[str, Any]:
        """OpenAI-style completion; with `tools`, signatures render into the
        system turn and <tool_call> blocks in the output parse back into
        tool_calls.

        `n` > 1 returns that many sampled completions and FORCES sampling:
        a zero temperature becomes 1.0. Text-only requests run all n rows
        as ONE batched decode over a fresh state (the prompt is tiled along
        the batch axis, the rows share the weight read); multimodal
        requests loop with distinct seeds, each on its own state.

        `stop` (string or list) truncates each completion at the earliest
        stop-sequence occurrence. `do_sample=False` forces greedy
        regardless of temperature (n > 1 overrides it back to sampled)."""
        from ..data.template import extract_tool_calls

        n = int(n)
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        stops = _normalize_stop(stop)
        if do_sample is False:
            temperature = 0.0  # greedy wins over the temperature knob
        if n > 1 and temperature == 0.0:
            temperature = 1.0  # n>1 needs sampling (reference semantics)
        # OpenAI wraps as {"type": "function", "function": {...}}
        fns = [t.get("function", t) for t in tools] if tools else None
        messages, images = _parse_content_parts(messages)
        if images:
            # multimodal request: prompt + pixels through the chat engine's
            # processor path (serve/chat.ChatModel)
            prep = self._mm_model()._prepare(messages, images=images, tools=fns)
            ids = prep.input_ids
            texts = []
            rows = []
            completion_tokens = 0
            with self.lock:
                for i in range(n):
                    out = self.generator.generate(
                        ids,
                        pixel_values=prep.pixel_values,
                        image_grid_thw=prep.image_grid_thw,
                        max_new_tokens=max_tokens,
                        temperature=temperature,
                        top_p=top_p,
                        seed=i,
                    )
                    texts.append(
                        self.tokenizer.decode(out[0], skip_special_tokens=True)
                    )
                    rows.append(np.asarray(out[0]))
                    completion_tokens += int(out.shape[1])
            finishes = self._stop_and_finish(texts, rows, stops)
            res = {
                "text": texts[0],
                "texts": texts,
                "finish_reasons": finishes,
                "prompt_tokens": int(np.asarray(ids).shape[1]),
                "completion_tokens": completion_tokens,
                "tool_calls": None,
            }
            if tools:
                parsed = [extract_tool_calls(t) for t in texts]
                res["tool_calls_list"] = [
                    p if isinstance(p, list) else None for p in parsed
                ]
                res["tool_calls"] = res["tool_calls_list"][0]
            return res
        prompt = self.template.render_prompt(
            messages, add_generation_prompt=True, tools=fns
        )
        ids = np.asarray(
            [self.tokenizer.encode(prompt, add_special_tokens=False)], np.int64
        )
        if n > 1:
            # all n completions as ONE batched decode: the tiled rows share
            # the weight read, and torch.multinomial draws each row
            # independently, so the n samples are i.i.d. under one seed
            with self.lock:
                out = self.generator.generate(
                    np.repeat(ids, n, axis=0),
                    max_new_tokens=max_tokens,
                    temperature=temperature,
                    top_p=top_p,
                )
            eos = self.generator.cfg.eos_token_id
            texts = []
            rows = []
            completion_tokens = 0
            for b in range(n):
                row = np.asarray(out[b])
                cut = np.where(row == eos)[0]
                if cut.size:  # per-row EOS; later columns are padding
                    row = row[: cut[0] + 1]
                rows.append(row)
                completion_tokens += int(row.shape[0])
                texts.append(
                    self.tokenizer.decode(row, skip_special_tokens=True)
                )
            finishes = self._stop_and_finish(texts, rows, stops)
            res = {
                "text": texts[0],
                "texts": texts,
                "finish_reasons": finishes,
                "prompt_tokens": int(ids.shape[1]),
                "completion_tokens": completion_tokens,
                "tool_calls": None,
            }
            if tools:
                parsed = [extract_tool_calls(t) for t in texts]
                res["tool_calls_list"] = [
                    p if isinstance(p, list) else None for p in parsed
                ]
                res["tool_calls"] = res["tool_calls_list"][0]
            return res
        spec_stats = None
        with self.lock:
            if self.draft_k > 0 and temperature == 0.0:
                from ..speculative import SpecStats

                spec_stats = SpecStats()
                out = self.generator.generate_speculative(
                    ids, max_new_tokens=max_tokens, draft_k=self.draft_k,
                    stats=spec_stats,
                )
            elif self.draft_k > 0:
                # sampled requests go through lossless rejection-sampled
                # speculation (speculative.generate_speculative_sampled):
                # same token distribution as plain sampling, several
                # drafts verified per weight read
                from ..speculative import SpecStats

                spec_stats = SpecStats()
                out = self.generator.generate_speculative_sampled(
                    ids, max_new_tokens=max_tokens, draft_k=self.draft_k,
                    temperature=temperature, top_p=top_p, stats=spec_stats,
                )
            else:
                out = self.generator.generate(
                    ids,
                    max_new_tokens=max_tokens,
                    temperature=temperature,
                    top_p=top_p,
                )
        texts = [self.tokenizer.decode(out[0], skip_special_tokens=True)]
        finishes = self._stop_and_finish(texts, [np.asarray(out[0])], stops)
        text = texts[0]
        res = {
            "text": text,
            "finish_reasons": finishes,
            "prompt_tokens": int(ids.shape[1]),
            "completion_tokens": int(out.shape[1]),
            "tool_calls": None,
        }
        if spec_stats is not None and spec_stats.forwards:
            # measured per-request acceptance (extension field; OpenAI
            # clients ignore unknown usage keys)
            res["speculation"] = {
                "draft_acceptance_rate": round(spec_stats.acceptance_rate, 4),
                "mean_accepted_per_window": round(spec_stats.mean_accepted, 3),
                "tokens_per_forward": round(spec_stats.tokens_per_forward, 3),
                "forwards": spec_stats.forwards,
            }
        if tools:
            parsed = extract_tool_calls(text)
            if isinstance(parsed, list):
                res["tool_calls"] = parsed
        return res

    def complete_stream(
        self,
        messages: List[Dict[str, str]],
        max_tokens: int = 512,
        temperature: float = 0.0,
        top_p: float = 1.0,
        parsed=None,
        stop=None,
        do_sample: Optional[bool] = None,
    ):
        """TRUE streaming: yields text deltas as decode chunks land.
        Incremental decode is cumulative-text diffing so tokenizers that
        merge tokens stay correct.

        `stop` sequences end the stream early; deltas hold back the last
        max(len(stop))-1 characters so a stop string split across two
        decode chunks is never partially emitted.

        `parsed` is an optional pre-computed _parse_content_parts result —
        the SSE handler validates content parts before sending headers and
        passes its result through so images are not decoded twice."""
        stops = _normalize_stop(stop)
        holdback = max((len(s) for s in stops), default=1) - 1
        if do_sample is False:
            temperature = 0.0
        messages, images = parsed or _parse_content_parts(messages)
        mm_kwargs: Dict[str, Any] = {}
        if images:
            prep = self._mm_model()._prepare(messages, images=images)
            ids = prep.input_ids
            mm_kwargs = {
                "pixel_values": prep.pixel_values,
                "image_grid_thw": prep.image_grid_thw,
            }
        else:
            prompt = self.template.render_prompt(
                messages, add_generation_prompt=True
            )
            ids = np.asarray(
                [self.tokenizer.encode(prompt, add_special_tokens=False)],
                np.int64,
            )
        eos = self.generator.cfg.eos_token_id
        with self.lock:
            toks: List[int] = []
            emitted = 0  # chars of cumulative text already yielded
            done = False
            for chunk in self.generator.generate_stream(
                ids,
                max_new_tokens=max_tokens,
                temperature=temperature,
                top_p=top_p,
                **mm_kwargs,
            ):
                for t in chunk[0]:
                    if int(t) == eos:
                        done = True
                        break
                    toks.append(int(t))
                text = self.tokenizer.decode(toks, skip_special_tokens=True)
                if stops:
                    text, hit = _truncate_at_stop(text, stops)
                    done = done or hit
                # hold back a stop-prefix-sized tail until the stream ends
                safe = len(text) if done else max(emitted, len(text) - holdback)
                if safe > emitted:
                    yield text[emitted:safe]
                    emitted = safe
                if done:
                    return
            # stream exhausted (max_tokens): flush the held-back tail
            text = self.tokenizer.decode(toks, skip_special_tokens=True)
            if stops:
                text, _ = _truncate_at_stop(text, stops)
            if len(text) > emitted:
                yield text[emitted:]

    def get_scores(
        self, texts: List[str], max_length: Optional[int] = None
    ) -> List[float]:
        """Reward-model scoring (/v1/score/evaluation): value-head output
        at the last token of each text. Requires reward-model params (a
        'value_head' tree from the rm stage). Each text runs a stateless
        forward of its own (no padding: an eager forward compiles nothing,
        and no text shares a state with another)."""
        params = self.generator.params
        text_params = params.get("text", params)
        if "value_head" not in text_params:
            raise ValueError(
                "scoring requires reward-model params (train with stage: rm)"
            )
        cfg = self.generator.cfg.text
        dev = self.generator.device
        out = []
        with self.lock:
            for s in texts:
                ids = self.tokenizer.encode(s, add_special_tokens=False)
                if max_length:
                    ids = ids[:max_length]
                if not ids:
                    raise ValueError("cannot score an empty text")
                row = torch.as_tensor([ids], dtype=torch.long, device=dev)
                pos = torch.arange(len(ids), device=dev).expand(3, 1, -1)
                hidden, _ = _score_forward(text_params, cfg, row, pos)
                v = hidden[:, -1] @ text_params["value_head"]["kernel"].to(hidden.dtype)
                out.append(float(v[0, 0]))
        return out


def _score_forward(text_params, cfg, ids, pos):
    """Final-normed hidden states of a stateless text forward."""
    from ..models.text import embed_tokens, text_forward

    return text_forward(text_params, cfg, embed_tokens(text_params, ids), pos, None)


def _choice(index: int, text: str, tool_calls, finish: str = "stop") -> Dict[str, Any]:
    message: Dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        message["content"] = ""
        message["tool_calls"] = [
            {
                "id": f"call_{uuid.uuid4().hex[:8]}",
                "type": "function",
                "function": {
                    "name": c["name"],
                    "arguments": json.dumps(c["arguments"], ensure_ascii=False),
                },
            }
            for c in tool_calls
        ]
        finish = "tool_calls"
    return {"index": index, "message": message, "finish_reason": finish}


def _chat_response(backend: ChatBackend, req: Dict[str, Any]) -> Dict[str, Any]:
    res = backend.complete(
        req.get("messages", []),
        max_tokens=req.get("max_tokens", 512),
        temperature=req.get("temperature", 0.0),
        top_p=req.get("top_p", 1.0),
        tools=req.get("tools"),
        n=req.get("n", 1),
        stop=req.get("stop"),
        do_sample=req.get("do_sample"),
    )
    texts = res.get("texts") or [res["text"]]
    calls = list(res.get("tool_calls_list") or [res.get("tool_calls")])
    calls += [None] * (len(texts) - len(calls))
    finishes = list(res.get("finish_reasons") or [])
    finishes += ["stop"] * (len(texts) - len(finishes))
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": req.get("model", backend.model_name),
        "choices": [
            _choice(i, t, c, f)
            for i, (t, c, f) in enumerate(zip(texts, calls, finishes))
        ],
        "usage": {
            "prompt_tokens": res["prompt_tokens"],
            "completion_tokens": res["completion_tokens"],
            "total_tokens": res["prompt_tokens"] + res["completion_tokens"],
            **(
                {"speculation": res["speculation"]}
                if res.get("speculation")
                else {}
            ),
        },
    }


def make_handler(backend: ChatBackend, api_key: Optional[str] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _auth_ok(self) -> bool:
            if api_key is None:
                return True
            header = self.headers.get("Authorization", "")
            return header == f"Bearer {api_key}"

        def do_GET(self):
            if self.path in ("/", "/ui"):
                # minimal built-in web chat: a dependency-free page over
                # the same /v1 API
                body = _UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if not self._auth_ok():
                return self._send(401, {"error": "invalid api key"})
            if self.path == "/v1/models":
                return self._send(
                    200,
                    {
                        "object": "list",
                        "data": [
                            {
                                "id": backend.model_name,
                                "object": "model",
                                "owned_by": "infinitevl-torch",
                            }
                        ],
                    },
                )
            return self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if not self._auth_ok():
                return self._send(401, {"error": "invalid api key"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad request: {e}"})
            if self.path == "/v1/score/evaluation":
                return self._score(req)
            if self.path != "/v1/chat/completions":
                return self._send(404, {"error": f"unknown path {self.path}"})
            if not isinstance(req.get("messages"), list) or not req["messages"]:
                return self._send(400, {"error": "messages must be a non-empty list"})
            if req.get("stream"):
                return self._stream(req)
            try:
                return self._send(200, _chat_response(backend, req))
            except ValueError as e:  # bad content parts (remote image
                # URLs, unknown part types) are caller errors
                return self._send(400, {"error": str(e)})
            except Exception as e:  # surface model errors as 500s
                return self._send(500, {"error": str(e)})

        def _score(self, req):
            # reference ScoreEvaluationRequest: {model, messages: [str], max_length}
            texts = req.get("messages")
            if not isinstance(texts, list) or not all(
                isinstance(t, str) for t in texts
            ) or not texts:
                return self._send(
                    400, {"error": "messages must be a non-empty list of strings"}
                )
            try:
                scores = backend.get_scores(texts, req.get("max_length"))
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            return self._send(
                200,
                {
                    "id": f"scoreval-{uuid.uuid4().hex[:12]}",
                    "object": "score.evaluation",
                    "model": req.get("model", backend.model_name),
                    "scores": scores,
                },
            )

        def _stream(self, req):
            # SSE with TRUE streaming: each decode chunk is flushed to
            # the client as soon as its tokens land on the host.
            # Validate content parts BEFORE committing the 200/SSE headers —
            # complete_stream is a generator, so a bad image part would
            # otherwise surface only after headers are sent and drop the
            # connection mid-stream instead of returning a 400.
            try:
                parsed = _parse_content_parts(req.get("messages", []))
                _normalize_stop(req.get("stop"))  # bad stop -> 400 pre-SSE
            except ValueError as e:
                return self._send(400, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            for piece in backend.complete_stream(
                req.get("messages", []),
                max_tokens=req.get("max_tokens", 512),
                temperature=req.get("temperature", 0.0),
                top_p=req.get("top_p", 1.0),
                parsed=parsed,
                stop=req.get("stop"),
                do_sample=req.get("do_sample"),
            ):
                chunk = {
                    "id": rid,
                    "object": "chat.completion.chunk",
                    "choices": [
                        {"index": 0, "delta": {"content": piece}, "finish_reason": None}
                    ],
                }
                self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                self.wfile.flush()
            done = {
                "id": rid,
                "object": "chat.completion.chunk",
                "choices": [{"index": 0, "delta": {}, "finish_reason": "stop"}],
            }
            self.wfile.write(f"data: {json.dumps(done)}\n\n".encode())
            self.wfile.write(b"data: [DONE]\n\n")

    return Handler


_UI_HTML = """<!doctype html><html><head><title>InfiniteVL</title>
<style>body{font-family:sans-serif;max-width:720px;margin:2em auto}
#log{border:1px solid #ccc;padding:1em;min-height:200px;white-space:pre-wrap}
input{width:80%%;padding:.5em}button{padding:.5em 1em}</style></head><body>
<h2>InfiniteVL chat</h2><div id=log></div>
<p><input id=msg placeholder="Say something..."><button onclick=send()>Send</button></p>
<script>
const hist=[];
async function send(){
 const m=document.getElementById('msg').value; if(!m)return;
 hist.push({role:'user',content:m});
 document.getElementById('log').textContent+='\\nYou: '+m;
 document.getElementById('msg').value='';
 const r=await fetch('/v1/chat/completions',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({messages:hist,max_tokens:256})});
 const j=await r.json();
 const a=j.choices[0].message.content;
 hist.push({role:'assistant',content:a});
 document.getElementById('log').textContent+='\\nAssistant: '+a;
}
</script></body></html>"""


def create_server(
    backend: ChatBackend,
    host: str = "127.0.0.1",
    port: int = 8000,
    api_key: Optional[str] = None,
) -> ThreadingHTTPServer:
    """The server, not yet serving (call serve_forever on it). Port 0 picks
    a free port (server.server_address[1])."""
    return ThreadingHTTPServer((host, port), make_handler(backend, api_key))


def run_api(backend: ChatBackend, host="127.0.0.1", port=8000, api_key=None):
    server = create_server(backend, host, port, api_key)
    print(f"API listening on http://{host}:{port}/v1 (OpenAI-compatible)")
    server.serve_forever()
