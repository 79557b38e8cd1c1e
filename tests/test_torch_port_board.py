"""The port's training web board (infinitevl_tpu_torch/serve/webui.py) on
the CPU: every case of tests/test_board.py against the port's server
(device="cpu"), the refusal to fall back to the CPU without a card, and
one SFT run started through the JAX board and through the port's from the
same exported checkpoint, whose logged losses agree within 1e-4."""

import base64
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml
from torch_port_helpers import freeze_inv_freq
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")

torch.set_num_threads(2)


def _req(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    if payload is not None:
        r = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
    else:
        r = url
    with urllib.request.urlopen(r) as resp:
        return json.loads(resp.read())


def _expect_400(port, path, payload=None):
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(port, path, payload)
    assert e.value.code == 400


def _wait(port, path, done, polls=240):
    for _ in range(polls):
        st = _req(port, path)
        if done(st):
            return st
        time.sleep(0.25)
    raise AssertionError(f"{path} did not finish: {st}")


def _serve(create, root, **kw):
    server = create(host="127.0.0.1", port=0, runs_root=str(root), **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture()
def board(tmp_path):
    from infinitevl_tpu_torch.serve.webui import create_board_server

    server = _serve(create_board_server, tmp_path, device="cpu")
    yield server.server_address[1], str(tmp_path)
    server.shutdown()
    server.server_close()


def test_board_page_and_status(board):
    port, _ = board
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        html = r.read().decode()
    assert "InfiniteVL-TPU board" in html
    for tab in ("Train", "Evaluate", "Chat", "Export"):
        assert f">{tab}</button>" in html
    assert _req(port, "/api/status") == {"running": False}
    # i18n dictionary + language selector (reference webui/locales.py role)
    assert "I18N" in html and "lang_sel" in html and "setLang" in html
    assert "训练" in html  # zh "train"
    assert "adam_mini" in html and "report_to" in html
    # progress bar + ETA (LlamaBoard runner progress role)
    assert "prog_bar" in html and "max_steps" in html
    from infinitevl_tpu.serve.webui import _BOARD_HTML as jax_html
    from infinitevl_tpu_torch.serve.webui import _BOARD_HTML as port_html

    # the same tabs and knobs in the port's own copy; its charts and progress
    # bar read the step under the key the trainer's log writes
    assert port_html == jax_html.replace("r.step,", "r.current_steps,").replace(
        "last.step", "last.current_steps")


def test_board_without_a_card_raises_instead_of_running_on_the_cpu(monkeypatch):
    from infinitevl_tpu_torch.serve import webui

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        webui.create_board_server(host="127.0.0.1", port=0)


def test_board_train_run_and_log(board):
    port, root = board
    out = f"{root}/run1"
    cfg = {
        "config_preset": "tiny", "stage": "sft", "dataset": "demo", "dataset_dir": DATA,
        "cutoff_len": 32, "per_device_train_batch_size": 1, "max_steps": 2,
        "logging_steps": 1, "save_steps": 1000, "bf16": False, "output_dir": out,
    }
    assert _req(port, "/api/train", cfg).get("ok")
    # a duplicate start is refused while the run is in flight (400), unless
    # the tiny run already ended
    try:
        _req(port, "/api/train", cfg)
    except urllib.error.HTTPError as e:
        assert e.code == 400
    st = _wait(port, "/api/status", lambda s: not s["running"])
    assert not st.get("error"), st
    assert st.get("max_steps") == 2 and st.get("started_at"), st
    log = _req(port, f"/api/log?run={out}")
    assert [r["current_steps"] for r in log["records"] if "loss" in r] == [1, 2]
    assert out in _req(port, "/api/runs")["runs"]


def test_board_rejects_bad_config_and_traversal(board):
    port, _ = board
    _expect_400(port, "/api/train", {"stage": "sft", "bogus_key": 1})
    _expect_400(port, "/api/log?run=/etc")


def test_board_templates_dataset_and_configs(board):
    port, _ = board
    t = _req(port, "/api/templates")
    assert "qwen2_vl" in t["templates"] and len(t["templates"]) > 50
    prev = _req(port, f"/api/dataset?name=demo&dir={DATA}&template=qwen2_vl")
    assert prev["count"] > 0
    assert "<|im_start|>user" in prev["examples"][0]["rendered"]
    cfg = {"stage": "sft", "dataset": "demo", "cutoff_len": 64}
    assert _req(port, "/api/config/save", {"name": "t1", "config": cfg}).get("ok")
    assert "t1" in _req(port, "/api/config/list")["configs"]
    assert _req(port, "/api/config/get?name=t1")["config"] == cfg
    _expect_400(port, "/api/config/save", {"name": "../evil", "config": {}})


def test_board_eval_flow(board):
    port, _ = board
    res = _req(port, "/api/eval", {"config_preset": "tiny", "dataset": "mcq_demo",
                                   "dataset_dir": DATA, "n_shot": 2, "eval_batch_size": 2})
    assert res.get("ok"), res
    st = _wait(port, "/api/eval/status", lambda s: s["state"] in ("done", "error"))
    assert st["state"] == "done", st
    assert 0.0 <= st["results"]["accuracy"] <= 1.0


def _load_chat(port, **cfg):
    assert _req(port, "/api/chat/load", {"config_preset": "tiny", **cfg}).get("ok")
    st = _wait(port, "/api/chat/status", lambda s: s["state"] in ("ready", "error"))
    assert st["state"] == "ready", st


def test_board_chat_flow(board):
    port, _ = board
    _load_chat(port, template="qwen2_vl")
    out = _req(port, "/api/chat", {"messages": [{"role": "user", "content": "hi"}],
                                   "max_new_tokens": 4})
    assert "content" in out, out


def test_board_export_flow(board):
    port, root = board
    out = f"{root}/export1"
    res = _req(port, "/api/export",
               {"config_preset": "tiny", "template": "qwen2_vl", "output_dir": out})
    assert "error" not in res
    st = _wait(port, "/api/export/status", lambda s: s["state"] in ("done", "error"))
    assert st["state"] == "done", st
    assert os.path.exists(os.path.join(out, "model.safetensors"))
    assert os.path.exists(os.path.join(out, "config.json"))
    assert "TEMPLATE" in open(os.path.join(out, "Modelfile")).read()


def test_board_checkpoints_endpoint(board):
    """/api/checkpoints lists the steps of a run's checkpoints (the port's
    step_<n>.pt files) and refuses paths outside the runs root."""
    port, root = board
    run = f"{root}/ckrun"
    os.makedirs(os.path.join(run, "checkpoints"))
    for n in (5, 10):
        open(os.path.join(run, "checkpoints", f"step_{n}.pt"), "w").close()
    assert _req(port, f"/api/checkpoints?run={run}")["steps"] == [5, 10]
    _expect_400(port, "/api/checkpoints?run=/etc")


def test_board_eval_predict_mode(board):
    port, root = board
    res = _req(port, "/api/eval", {
        "mode": "predict", "config_preset": "tiny", "dataset": "demo", "dataset_dir": DATA,
        "cutoff_len": 32, "predict_samples": 2, "bf16": False,
        "output_dir": f"{root}/predict1"})
    assert res.get("ok"), res
    st = _wait(port, "/api/eval/status", lambda s: s["state"] in ("done", "error"))
    assert st["state"] == "done", st
    assert "rouge-l" in st["results"] and st["results"]["samples"] > 0


def test_board_chat_image_and_system(board):
    from PIL import Image

    port, _ = board
    _load_chat(port)
    img = Image.fromarray((np.random.RandomState(0).rand(56, 56, 3) * 255).astype(np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    out = _req(port, "/api/chat", {
        "messages": [{"role": "user", "content": "<image>what is it"}], "images": [uri],
        "system": "You are a terse assistant.", "max_new_tokens": 4})
    assert "content" in out, out


def test_board_datasets_and_preview_command(board):
    port, _ = board
    ds = _req(port, f"/api/datasets?dir={DATA}")
    assert "demo" in [d["name"] for d in ds["datasets"]]
    assert all("formatting" in d for d in ds["datasets"])
    assert _req(port, "/api/datasets?dir=/nonexistent") == {"datasets": []}
    cfg = {"stage": "sft", "dataset": "demo", "cutoff_len": 64, "bf16": True}
    prev = _req(port, "/api/preview", {"name": "t2", "config": cfg})
    assert "infinitevl_tpu_torch.cli train" in prev["command"]
    assert "t2.yaml" in prev["command"]
    assert yaml.safe_load(prev["yaml"]) == cfg


def test_board_sft_losses_match_the_jax_board(tmp_path, monkeypatch):
    """The same full-finetuning run from one exported checkpoint, started
    through each package's board: the logged losses agree within 1e-4
    (JAX's optimizer with rope's inv_freq frozen, as the port's full
    finetuning leaves it)."""
    import infinitevl_tpu.train.trainer as jtrainer
    from infinitevl_tpu.config import tiny_config
    from infinitevl_tpu.models.params import init_params
    from infinitevl_tpu.serve.webui import create_board_server as jax_board
    from infinitevl_tpu.utils.checkpoint import export_hf_safetensors
    from infinitevl_tpu_torch.serve.webui import create_board_server as port_board

    monkeypatch.setattr(jtrainer, "_make_tx", freeze_inv_freq(jtrainer._make_tx))
    ckpt = str(tmp_path / "ckpt")
    export_hf_safetensors(init_params(jax.random.PRNGKey(0), tiny_config(), jax.numpy.float32),
                          tiny_config(), ckpt)
    runs = {}  # both runs at once: each board trains on its own thread
    try:
        for name, create, kw in (("jax", jax_board, {}), ("port", port_board, {"device": "cpu"})):
            root = tmp_path / name
            server = _serve(create, root, **kw)
            runs[name] = (server, str(root / "run"))
            assert _req(server.server_address[1], "/api/train", {
                "model_name_or_path": ckpt, "stage": "sft", "finetuning_type": "full",
                "dataset": "demo", "dataset_dir": DATA, "cutoff_len": 128,
                "per_device_train_batch_size": 2, "max_steps": 3, "learning_rate": 1e-3,
                "lr_scheduler_type": "constant", "logging_steps": 1, "save_steps": 1000,
                "bf16": False, "output_dir": runs[name][1]}).get("ok")
        losses = {}
        for name, (server, out) in runs.items():
            port = server.server_address[1]
            st = _wait(port, "/api/status", lambda s: not s["running"], polls=1200)
            assert not st.get("error"), st
            losses[name] = [r["loss"] for r in _req(port, f"/api/log?run={out}")["records"]
                            if "loss" in r]
    finally:
        for server, _ in runs.values():
            server.shutdown()
            server.server_close()
    assert len(losses["jax"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=0, atol=1e-4)
