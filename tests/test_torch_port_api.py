"""The port's chat engine, OpenAI-style backend, HTTP server and processor
against the JAX package's at tiny_config(), on the CPU in fp32, from the
same weights and the repo's SimpleTokenizer on each side.

Greedy responses (plain, stop sequences, streaming chunks, speculation
usage, image requests) must be EQUAL to the JAX backend's; sampled ones
(n > 1) use each framework's own generator, so their structure is held, not
their draws. Scores agree to 1e-4. One real loopback HTTP round trip runs
on the CPU."""

import base64
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.data.processing as jproc
import infinitevl_tpu.serve.api as japi
import infinitevl_tpu_torch.data.processing as tproc
import infinitevl_tpu_torch.serve.api as tapi
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.data.loader import SimpleTokenizer as JSimpleTokenizer
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu.serve.chat import ChatModel as JChatModel
from infinitevl_tpu_torch.data.loader import SimpleTokenizer, resolve_tokenizer
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.params import from_jax_numpy
from infinitevl_tpu_torch.serve.chat import ChatModel, decode_image_uri

torch.set_num_threads(2)

CFG = tiny_config()
TCFG = to_port_config(CFG)
MESSAGES = [{"role": "user", "content": "tell me about the frames the frames the frames"}]


@pytest.fixture(scope="module")
def gens():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    tp = from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return JGenerator(jp, CFG), Generator(tp, TCFG, device="cpu")


@pytest.fixture(scope="module")
def backends(gens):
    jg, tg = gens
    return (japi.ChatBackend(jg, JSimpleTokenizer(config=CFG), model_name="m"),
            tapi.ChatBackend(tg, SimpleTokenizer(config=TCFG), model_name="m"))


def _image(seed=0, hw=(56, 84)):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3)).astype(np.uint8)


def _data_uri(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


# ------------------------------------------------------------ processing


@pytest.mark.parametrize("hw", [(56, 56), (100, 333), (1000, 30), (3000, 2000), (29, 29)])
def test_smart_resize_matches_jax(hw):
    assert tproc.smart_resize(*hw) == jproc.smart_resize(*hw)
    assert tproc.smart_resize(*hw, min_pixels=128 * 28 * 28, max_pixels=768 * 28 * 28) == \
        jproc.smart_resize(*hw, min_pixels=128 * 28 * 28, max_pixels=768 * 28 * 28)
    with pytest.raises(ValueError, match="aspect ratio"):
        tproc.smart_resize(10, 3000)


def test_image_video_and_sampling_match_jax():
    img = _image(1, (70, 120))
    (tf, tg_), (jf, jg_) = tproc.preprocess_image(img), jproc.preprocess_image(img)
    assert tg_ == jg_
    np.testing.assert_array_equal(tf, jf)
    clip = np.random.RandomState(2).randint(0, 256, (5, 60, 90, 3)).astype(np.uint8)
    got, want = tproc.preprocess_video(clip, fps=4.0), jproc.preprocess_video(clip, fps=4.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    for kw in (dict(src_fps=30.0), dict(src_fps=2.0, target_fps=1.0, min_frames=1),
               dict(src_fps=10.0, max_frames=3)):
        np.testing.assert_array_equal(tproc.sample_frames(clip, **kw),
                                      jproc.sample_frames(clip, **kw))
    f = img.astype(np.float32)
    np.testing.assert_array_equal(tproc._resize_bilinear_np(f, 28, 56),
                                  jproc._resize_bilinear_np(f, 28, 56))
    np.testing.assert_array_equal(tproc.resize_bicubic(img, 56, 56),
                                  jproc.resize_bicubic(img, 56, 56))
    with pytest.raises(ValueError, match=">= 28"):
        tproc.preprocess_image(img[:20])
    for name in ("IMAGE_PAD", "VIDEO_PAD", "VISION_START", "VISION_END"):
        assert getattr(tproc, name) == getattr(jproc, name)


def test_processor_matches_jax():
    tp = tproc.InfiniteVLProcessor(SimpleTokenizer(config=TCFG), TCFG)
    jp = jproc.InfiniteVLProcessor(JSimpleTokenizer(config=CFG), CFG)
    text = (f"look {tproc.VISION_START}{tproc.IMAGE_PAD}{tproc.VISION_END} and "
            f"{tproc.VISION_START}{tproc.VIDEO_PAD}{tproc.VISION_END} then answer")
    clip = np.random.RandomState(3).randint(0, 256, (4, 56, 56, 3)).astype(np.uint8)
    got = tp(text, images=[_image(4)], videos=[clip], fps=2.0)
    want = jp(text, images=[_image(4)], videos=[clip], fps=2.0)
    for field in ("input_ids", "pixel_values", "image_grid_thw", "pixel_values_videos",
                  "video_grid_thw"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.second_per_grid_ts == want.second_per_grid_ts
    n_img = int(np.prod(got.image_grid_thw[0])) // 4
    assert int((got.input_ids == TCFG.image_token_id).sum()) == n_img
    plain = tp("no pictures here")
    assert plain.pixel_values is None and plain.second_per_grid_ts is None


# ------------------------------------------------------------ the backend


def _same(tres, jres):
    assert tres.keys() == jres.keys()
    for k in jres:
        assert tres[k] == jres[k], k


def test_complete_greedy_stop_and_finish_match_jax(backends):
    jb, tb = backends
    jres, tres = jb.complete(MESSAGES, max_tokens=10), tb.complete(MESSAGES, max_tokens=10)
    _same(tres, jres)
    assert tres["completion_tokens"] == 10 and tres["finish_reasons"] == ["length"]
    # a stop sequence taken from the middle of the known output
    words = tres["text"].split(" ")
    stop = " ".join(words[4:6])
    jres2 = jb.complete(MESSAGES, max_tokens=10, stop=[stop, "never-there"])
    tres2 = tb.complete(MESSAGES, max_tokens=10, stop=[stop, "never-there"])
    _same(tres2, jres2)
    assert tres2["finish_reasons"] == ["stop"] and stop not in tres2["text"]
    assert tres["text"].startswith(tres2["text"]) and len(tres2["text"]) < len(tres["text"])
    # do_sample=False wins over a temperature
    _same(tb.complete(MESSAGES, max_tokens=10, temperature=0.9, do_sample=False), jres)
    with pytest.raises(ValueError, match="stop must be"):
        tb.complete(MESSAGES, stop=[1])
    with pytest.raises(ValueError, match="n must be"):
        tb.complete(MESSAGES, n=0)


def test_complete_n_rows_are_sampled_apart_on_a_fresh_state(backends):
    jb, tb = backends
    jres = jb.complete(MESSAGES, max_tokens=6, n=3)
    tres = tb.complete(MESSAGES, max_tokens=6, n=3, stop="never-there")
    assert tres.keys() == jres.keys()
    assert len(tres["texts"]) == 3 and tres["prompt_tokens"] == jres["prompt_tokens"]
    assert 3 <= tres["completion_tokens"] <= 18
    assert set(tres["finish_reasons"]) <= {"stop", "length"}
    # the request left nothing behind: the greedy answer is what it was
    _same(tb.complete(MESSAGES, max_tokens=10), jb.complete(MESSAGES, max_tokens=10))


def test_complete_with_speculation_reports_equal_usage(gens):
    jg, tg = gens
    jb = japi.ChatBackend(jg, JSimpleTokenizer(config=CFG), model_name="m", draft_k=4)
    tb = tapi.ChatBackend(tg, SimpleTokenizer(config=TCFG), model_name="m", draft_k=4)
    jres, tres = jb.complete(MESSAGES, max_tokens=10), tb.complete(MESSAGES, max_tokens=10)
    _same(tres, jres)
    assert tres["speculation"]["forwards"] > 0
    plain = tapi.ChatBackend(tg, SimpleTokenizer(config=TCFG)).complete(MESSAGES, max_tokens=10)
    assert plain["text"] == tres["text"] and "speculation" not in plain
    resp = tapi._chat_response(tb, {"messages": MESSAGES, "max_tokens": 10})
    assert resp["usage"]["speculation"] == tres["speculation"]
    # sampled requests route through rejection-sampled speculation (numpy draws)
    _same(tb.complete(MESSAGES, max_tokens=8, temperature=0.8),
          jb.complete(MESSAGES, max_tokens=8, temperature=0.8))


def test_stream_chunks_match_jax(backends):
    jb, tb = backends
    want = list(jb.complete_stream(MESSAGES, max_tokens=12))
    got = list(tb.complete_stream(MESSAGES, max_tokens=12))
    assert got == want and len(got) >= 2
    full = tb.complete(MESSAGES, max_tokens=12)["text"]
    assert "".join(got) == full
    stop = " ".join(full.split(" ")[5:7])
    want = list(jb.complete_stream(MESSAGES, max_tokens=12, stop=stop))
    got = list(tb.complete_stream(MESSAGES, max_tokens=12, stop=stop))
    assert got == want and stop not in "".join(got)
    assert "".join(got) == full[:full.find(stop)]


class _Scripted:
    """A generator / tokenizer pair that answers with a fixed text: holds
    the API layer alone (tool-call parsing, choices, finish reasons)."""

    def __init__(self, cfg, text, device=None):
        self.cfg, self.text, self.params, self.device = cfg, text, {}, device
        self.eos_token_id = cfg.eos_token_id

    def generate(self, ids, **kw):
        return np.tile(np.array([[5, 6, 7]]), (np.asarray(ids).shape[0], 1))

    def encode(self, text, add_special_tokens=False):
        return list(range(len(text.split())))

    def decode(self, ids, skip_special_tokens=True):
        return self.text


def _strip(resp):
    resp = json.loads(json.dumps(resp))
    resp.pop("id"), resp.pop("created")
    for ch in resp["choices"]:
        for call in ch["message"].get("tool_calls", []):
            assert call.pop("id").startswith("call_")
    return resp


def test_tool_calls_and_choices_match_jax():
    text = ('I will look it up <tool_call>\n{"name": "get_weather", "arguments": '
            '{"city": "Paris", "unit": "C"}}\n</tool_call>')
    tools = [{"type": "function", "function": {
        "name": "get_weather", "description": "weather by city",
        "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}}]
    js, ts = _Scripted(CFG, text), _Scripted(TCFG, text, torch.device("cpu"))
    jb, tb = japi.ChatBackend(js, js, model_name="m"), tapi.ChatBackend(ts, ts, model_name="m")
    for n in (1, 2):
        req = {"messages": MESSAGES, "tools": tools, "n": n, "max_tokens": 5}
        got, want = _strip(tapi._chat_response(tb, req)), _strip(japi._chat_response(jb, req))
        assert got == want
        assert len(got["choices"]) == n
        ch = got["choices"][0]
        assert ch["finish_reason"] == "tool_calls" and ch["message"]["content"] == ""
        fn = ch["message"]["tool_calls"][0]["function"]
        assert fn["name"] == "get_weather"
        assert json.loads(fn["arguments"]) == {"city": "Paris", "unit": "C"}
    # no tools in the request: the text comes back as it is
    got = _strip(tapi._chat_response(tb, {"messages": MESSAGES}))
    assert got == _strip(japi._chat_response(jb, {"messages": MESSAGES}))
    assert got["choices"][0]["message"]["content"] == text
    assert tb.complete(MESSAGES, tools=tools)["tool_calls"] == \
        jb.complete(MESSAGES, tools=tools)["tool_calls"]


def test_image_request_matches_jax(backends):
    jb, tb = backends
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "what is this"},
        {"type": "image_url", "image_url": {"url": _data_uri(_image(5))}}]}]
    jres, tres = jb.complete(msgs, max_tokens=5), tb.complete(msgs, max_tokens=5)
    _same(tres, jres)
    assert tres["prompt_tokens"] > 6  # 56x84 pixels: 2x3 merged image tokens
    assert list(tb.complete_stream(msgs, max_tokens=5)) == \
        list(jb.complete_stream(msgs, max_tokens=5))
    for bad in ("https://example.com/x.png", "data:image/png;base64,@@@", "data:image/png"):
        part = [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": bad}}]}]
        with pytest.raises(ValueError):
            tb.complete(part)
    with pytest.raises(ValueError, match="unsupported content part"):
        tb.complete([{"role": "user", "content": [{"type": "audio"}]}])
    np.testing.assert_array_equal(decode_image_uri(_data_uri(_image(5))), _image(5))


def test_get_scores_matches_jax(gens):
    jg, tg = gens
    head = np.random.RandomState(0).standard_normal((CFG.text.hidden_size, 1)).astype(np.float32)
    jparams = {**jg.params, "text": {**jg.params["text"],
                                     "value_head": {"kernel": jnp.asarray(head)}}}
    tparams = {**tg.params, "text": {**tg.params["text"],
                                     "value_head": {"kernel": torch.from_numpy(head)}}}
    jb = japi.ChatBackend(JGenerator(jparams, CFG), JSimpleTokenizer(config=CFG))
    tb = tapi.ChatBackend(Generator(tparams, TCFG, device="cpu"), SimpleTokenizer(config=TCFG))
    texts = ["a good answer to the question", "bad"]
    want, got = jb.get_scores(texts), tb.get_scores(texts)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.get_scores(texts[:1], max_length=3),
                               jb.get_scores(texts[:1], max_length=3), rtol=1e-4, atol=1e-5)
    # scoring one text does not move another's score (no shared state)
    assert tb.get_scores(texts[1:]) == got[1:]
    with pytest.raises(ValueError, match="reward-model"):
        tapi.ChatBackend(tg, SimpleTokenizer(config=TCFG)).get_scores(texts)


# ------------------------------------------------------------ the chat model


def test_chat_model_matches_jax(gens):
    jg, tg = gens
    jm = JChatModel(jg, JSimpleTokenizer(config=CFG))
    tm = ChatModel(tg, SimpleTokenizer(config=TCFG))
    assert tm.chat(MESSAGES, max_new_tokens=8) == jm.chat(MESSAGES, max_new_tokens=8)
    want = list(jm.stream_chat(MESSAGES, max_new_tokens=8))
    assert list(tm.stream_chat(MESSAGES, max_new_tokens=8)) == want
    mm = [{"role": "user", "content": "<image> what is this"}]
    assert tm.chat(mm, images=[_image(5)], max_new_tokens=5) == \
        jm.chat(mm, images=[_image(5)], max_new_tokens=5)
    assert tm.chat(MESSAGES, max_new_tokens=6, num_beams=2) == \
        jm.chat(MESSAGES, max_new_tokens=6, num_beams=2)
    texts = tm.chat(MESSAGES, max_new_tokens=4, num_return_sequences=2)
    assert isinstance(texts, list) and len(texts) == 2
    with pytest.raises(ValueError, match="greedy beam search"):
        tm.chat(MESSAGES, num_beams=2, temperature=0.5)
    with pytest.raises(ValueError, match="text-only"):
        tm.chat(mm, images=[_image(5)], num_beams=2)
    # speculative routing: the same text, with the request's measured stats
    ts, js = ChatModel(tg, SimpleTokenizer(config=TCFG), draft_k=4), \
        JChatModel(jg, JSimpleTokenizer(config=CFG), draft_k=4)
    assert ts.chat(MESSAGES, max_new_tokens=8) == tm.chat(MESSAGES, max_new_tokens=8)
    js.chat(MESSAGES, max_new_tokens=8)
    assert ts.last_spec_stats.summary() == js.last_spec_stats.summary()


# ------------------------------------------------------------ HTTP


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    return resp.status, data


def test_loopback_http_round_trip(backends):
    _, tb = backends
    server = tapi.create_server(tb, "127.0.0.1", 0, api_key="secret")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    auth = {"Authorization": "Bearer secret"}
    try:
        assert _request(port, "GET", "/v1/models")[0] == 401
        status, data = _request(port, "GET", "/v1/models", headers=auth)
        assert status == 200 and json.loads(data)["data"][0]["id"] == "m"
        status, page = _request(port, "GET", "/")
        assert status == 200 and "<html>" in page
        body = {"messages": MESSAGES, "max_tokens": 10}
        status, data = _request(port, "POST", "/v1/chat/completions", body, auth)
        resp = json.loads(data)
        want = tb.complete(MESSAGES, max_tokens=10)
        assert status == 200 and resp["object"] == "chat.completion" and resp["model"] == "m"
        assert resp["choices"][0]["message"] == {"role": "assistant", "content": want["text"]}
        assert resp["choices"][0]["finish_reason"] == "length"
        assert resp["usage"] == {"prompt_tokens": want["prompt_tokens"],
                                 "completion_tokens": 10,
                                 "total_tokens": want["prompt_tokens"] + 10}
        status, data = _request(port, "POST", "/v1/chat/completions",
                                {**body, "stream": True}, auth)
        events = [line[6:] for line in data.split("\n") if line.startswith("data: ")]
        assert status == 200 and events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
        assert text == want["text"] and len(chunks) >= 3
        assert _request(port, "POST", "/v1/chat/completions", {"messages": []}, auth)[0] == 400
        assert _request(port, "POST", "/v1/chat/completions",
                        {"messages": MESSAGES, "stream": True, "stop": [3]}, auth)[0] == 400
        assert _request(port, "POST", "/v1/nothing", body, auth)[0] == 404
        assert _request(port, "POST", "/v1/score/evaluation", {"messages": ["x"]}, auth)[0] == 400
        assert _request(port, "POST", "/v1/chat/completions", body)[0] == 401
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_resolve_tokenizer():
    tok = SimpleTokenizer(config=TCFG)
    assert resolve_tokenizer(tokenizer=tok) is tok
    made = resolve_tokenizer(cfg=TCFG)
    assert isinstance(made, SimpleTokenizer) and made.eos_token_id == TCFG.eos_token_id
    assert made.vocab["<|image_pad|>"] == TCFG.image_token_id
