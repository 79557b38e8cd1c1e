"""Training web board (torch port of infinitevl_tpu/serve/webui.py): the
dependency-free counterpart of the reference's Gradio LlamaBoard
(src/llamafactory/webui/, 5.5K LoC).

One page served from the stdlib HTTP server, with the LlamaBoard tab set
(webui/components/{train,eval,chat,export}.py):
- Train: a config form covering the common TrainArgs/DataArgs/FinetuneArgs
  knobs with YAML preview (LlamaBoard's "preview command"), dataset
  preview, config save/load, start/abort for a single background run
  (run_exp in a thread; LlamaBoard's Runner also serializes to one run),
  and live metric charts polled from the run's trainer_log.jsonl (one
  small chart per metric — loss / reward / kl / tokens_per_sec have
  different scales, so they never share an axis)
- Evaluate: background MCQ evaluation (eval/mcq.py) with an accuracy table
- Chat: load a model into a ChatModel and converse (webui chat tab role)
- Export: HF safetensors + ollama Modelfile

Every runner works on one device, resolved once when the server is made
(`device.resolve_device`): the CUDA card, or the CPU's plain versions when
the caller passes device="cpu".

Launch: `python -m infinitevl_tpu_torch.cli board [port] [--device cpu]` or
`from infinitevl_tpu_torch.serve.webui import run_board`.
"""

from __future__ import annotations

import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import torch

from ..device import Device, resolve_device


class TrainRunner:
    """Single in-flight training run (webui/runner.py equivalent)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.thread: Optional[threading.Thread] = None
        self.abort_event = threading.Event()
        self.status: Dict[str, Any] = {"running": False}
        self.lock = threading.Lock()

    def start(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import time

        from ..hparams import parse_args
        from ..train import trainer as trainer_mod

        with self.lock:
            if self.thread is not None and self.thread.is_alive():
                return {"error": "a run is already in progress"}
            try:
                args = parse_args(config)
            except (ValueError, TypeError) as e:
                return {"error": f"bad config: {e}"}
            self.abort_event.clear()
            self.status = {
                "running": True,
                "stage": args.finetune.stage,
                "output_dir": args.train.output_dir,
                # progress-bar/ETA inputs (LlamaBoard's runner progress,
                # webui/runner.py get_trainer_info role): the UI combines
                # max_steps with the last logged step and started_at
                "max_steps": args.train.max_steps or None,
                "started_at": time.time(),
                "error": None,
            }

            def work():
                try:
                    trainer_mod.ABORT_EVENT = self.abort_event
                    trainer_mod.run_exp(args, device=self.device)
                    self.status["running"] = False
                except Exception as e:  # surfaced to the board
                    self.status["running"] = False
                    self.status["error"] = f"{type(e).__name__}: {e}"
                    traceback.print_exc()
                finally:
                    trainer_mod.ABORT_EVENT = None

            self.thread = threading.Thread(target=work, daemon=True)
            self.thread.start()
            return {"ok": True, "output_dir": args.train.output_dir}

    def abort(self) -> Dict[str, Any]:
        self.abort_event.set()
        return {"ok": True, "aborting": self.thread is not None and self.thread.is_alive()}


class ExportRunner:
    """Background HF-safetensors + ollama-Modelfile export (the reference
    LlamaBoard's export tab, webui/components/export.py role)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.status: Dict[str, Any] = {"state": "idle"}
        self._thread = None
        self._lock = threading.Lock()

    def start(self, config: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._thread and self._thread.is_alive():
                return {"error": "export already running"}
            # set synchronously: the UI polls right after POST and must not
            # observe 'idle' while the worker is still importing/parsing
            self.status = {
                "state": "running",
                "output_dir": config.get("output_dir", "output"),
            }

            def work():
                try:
                    from ..cli import _load_params
                    from ..data.template import (
                        get_ollama_modelfile,
                        get_template,
                    )
                    from ..hparams import parse_args
                    from ..utils.checkpoint import export_hf_safetensors

                    args = parse_args(dict(config))
                    out = args.train.output_dir
                    self.status = {"state": "running", "output_dir": out}
                    # the unquantised weights: the HF layout stores no int8 / int4
                    params, cfg, _ = _load_params(args, self.device)
                    export_hf_safetensors(params, cfg, out)
                    with open(os.path.join(out, "Modelfile"), "w") as f:
                        f.write(
                            get_ollama_modelfile(
                                get_template(args.data.template)
                            )
                        )
                    self.status = {"state": "done", "output_dir": out}
                except Exception as e:  # noqa: BLE001 - surfaced to the UI
                    self.status = {
                        "state": "error",
                        "error": f"{type(e).__name__}: {e}",
                    }

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            return {
                "ok": True,
                "output_dir": config.get("output_dir", "output"),
            }


class EvalRunner:
    """Background MCQ evaluation (the reference LlamaBoard's 'Evaluate &
    Predict' tab, webui/components/eval.py role). One eval at a time;
    results land in status['results']."""

    def __init__(self, device: torch.device):
        self.device = device
        self.status: Dict[str, Any] = {"state": "idle"}
        self._thread = None
        self._lock = threading.Lock()

    def start(self, config: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._thread and self._thread.is_alive():
                return {"error": "an eval is already running"}
            self.status = {"state": "running"}

            def work():
                try:
                    from ..cli import _build_generator, _tokenizer
                    from ..eval.mcq import MCQEvaluator
                    from ..hparams import parse_args

                    if config.pop("mode", "mcq") == "predict":
                        # SFT predict path (LlamaBoard's "Evaluate & Predict"
                        # second half): greedy-generate predict_samples
                        # examples, BLEU-4/ROUGE vs gold
                        # (train/trainer.predict_and_score). 0 epochs skips
                        # training (max_steps=0 is falsy and would fall back
                        # to the epoch-derived count); predict runs on the
                        # loaded params.
                        from ..train import trainer as trainer_mod

                        args = parse_args(
                            dict(
                                config,
                                stage="sft",
                                do_predict=True,
                                num_train_epochs=0,
                            )
                        )
                        trainer_mod.run_exp(args, device=self.device)
                        with open(
                            os.path.join(
                                args.train.output_dir,
                                "predict_results.json",
                            )
                        ) as f:
                            self.status = {
                                "state": "done",
                                "results": json.load(f),
                            }
                        return
                    args = parse_args(dict(config))
                    gen, cfg = _build_generator(args, self.device)
                    evaluator = MCQEvaluator(
                        gen,
                        _tokenizer(args, cfg),
                        batch_size=args.eval.eval_batch_size,
                        lang=args.eval.lang,
                    )
                    task_path = os.path.join(
                        args.data.dataset_dir, f"{args.data.dataset}.json"
                    )
                    with open(task_path) as f:
                        task = json.load(f)
                    if isinstance(task, dict):
                        metrics = evaluator.evaluate_task(
                            task, n_shot=args.eval.n_shot
                        )
                    else:
                        metrics = evaluator.evaluate(task)
                    self.status = {"state": "done", "results": metrics}
                except Exception as e:  # noqa: BLE001 - surfaced to the UI
                    self.status = {
                        "state": "error",
                        "error": f"{type(e).__name__}: {e}",
                    }

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            return {"ok": True}


class ChatRunner:
    """Chat tab backend: load a model once (background — weights and the
    kernels' first build take a while), then serve chat turns through
    ChatModel."""

    def __init__(self, device: torch.device):
        self.device = device
        self.status: Dict[str, Any] = {"state": "empty"}
        self.model = None
        self._thread = None
        self._lock = threading.Lock()

    def load(self, config: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if self._thread and self._thread.is_alive():
                return {"error": "a model is already loading"}
            self.status = {"state": "loading"}
            self.model = None

            def work():
                try:
                    from ..cli import _build_generator, _tokenizer
                    from ..hparams import parse_args
                    from .chat import ChatModel

                    args = parse_args(dict(config))
                    gen, cfg = _build_generator(args, self.device)
                    self.model = ChatModel(
                        gen, _tokenizer(args, cfg),
                        template=args.data.template,
                        draft_k=args.gen.draft_k,
                    )
                    self.status = {
                        "state": "ready",
                        "template": args.data.template,
                        "quant": {8: "int8", 4: "int4"}.get(
                            args.model.quantization_bit
                        ),
                    }
                except Exception as e:  # noqa: BLE001 - surfaced to the UI
                    self.status = {
                        "state": "error",
                        "error": f"{type(e).__name__}: {e}",
                    }

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            return {"ok": True}

    def chat(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self.model is None:
            return {"error": "no model loaded (POST /api/chat/load first)"}
        try:
            messages = list(req.get("messages", []))
            system = (req.get("system") or "").strip()
            if system and not any(m.get("role") == "system" for m in messages):
                messages.insert(0, {"role": "system", "content": system})
            images = None
            if req.get("images"):
                # data-URI uploads from the board's file input (the
                # LlamaBoard chat tab's image box role)
                from .chat import decode_image_uri

                images = [decode_image_uri(uri) for uri in req["images"]]
            text = self.model.chat(
                messages,
                images=images,
                max_new_tokens=int(req.get("max_new_tokens", 256)),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 1.0)),
            )
            return {"content": text}
        except Exception as e:  # noqa: BLE001 - surfaced to the UI
            return {"error": f"{type(e).__name__}: {e}"}


def _dataset_preview(
    name: str, dataset_dir: str, template: str, n: int = 3
) -> Dict[str, Any]:
    """First n examples of a registry dataset, raw + template-rendered
    (LlamaBoard's 'preview dataset' button, webui/components/data.py)."""
    from ..data.loader import load_dataset_info, load_examples
    from ..data.template import get_template

    registry = load_dataset_info(
        os.path.join(dataset_dir, "dataset_info.json")
    )
    if name not in registry:
        raise KeyError(
            f"dataset {name!r} not in registry; available: {sorted(registry)}"
        )
    examples = load_examples(registry[name], dataset_dir)[:n]
    tpl = get_template(template)
    rows = []
    for ex in examples:
        rows.append(
            {
                "messages": ex.get("messages"),
                "rendered": tpl.render_prompt(
                    ex.get("messages", []), add_generation_prompt=False
                ),
            }
        )
    return {"count": len(rows), "examples": rows}


def _config_dir(runs_root: str) -> str:
    d = os.path.join(runs_root, "board_configs")
    os.makedirs(d, exist_ok=True)
    return d


def _safe_config_path(runs_root: str, name: str) -> Optional[str]:
    base = os.path.basename(name)
    if not base or base != name or not base.replace("-", "").replace(
        "_", ""
    ).replace(".", "").isalnum():
        return None
    if not base.endswith(".yaml"):
        base += ".yaml"
    return os.path.join(_config_dir(runs_root), base)


def _read_log(output_dir: str, limit: int = 2000):
    path = os.path.join(output_dir, "trainer_log.jsonl")
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return recs[-limit:]


def make_board_handler(
    runner: TrainRunner,
    runs_root: str = "output",
    exporter: Optional[ExportRunner] = None,
    evaluator: Optional[EvalRunner] = None,
    chatter: Optional[ChatRunner] = None,
):
    exporter = exporter or ExportRunner(runner.device)
    evaluator = evaluator or EvalRunner(runner.device)
    chatter = chatter or ChatRunner(runner.device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/board"):
                body = _BOARD_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/api/status":
                return self._json(200, runner.status)
            if self.path == "/api/export/status":
                return self._json(200, exporter.status)
            if self.path == "/api/eval/status":
                return self._json(200, evaluator.status)
            if self.path == "/api/chat/status":
                return self._json(200, chatter.status)
            if self.path == "/api/templates":
                from ..data.template import _TEMPLATES

                return self._json(200, {"templates": sorted(_TEMPLATES)})
            if self.path.startswith("/api/datasets"):
                # registry listing for the dataset dropdown (LlamaBoard's
                # list_datasets role, webui/common.py)
                from urllib.parse import parse_qs, urlparse

                from ..data.loader import load_dataset_info

                q = parse_qs(urlparse(self.path).query)
                ddir = q.get("dir", ["data"])[0]
                try:
                    registry = load_dataset_info(
                        os.path.join(ddir, "dataset_info.json")
                    )
                except FileNotFoundError:
                    return self._json(200, {"datasets": []})
                return self._json(
                    200,
                    {"datasets": [
                        {
                            "name": k,
                            "formatting": v.formatting,
                            "num_samples": v.num_samples,
                        }
                        for k, v in sorted(registry.items())
                    ]},
                )
            if self.path.startswith("/api/dataset"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    return self._json(
                        200,
                        _dataset_preview(
                            q.get("name", ["demo"])[0],
                            q.get("dir", ["data"])[0],
                            q.get("template", ["qwen2_vl"])[0],
                        ),
                    )
                except Exception as e:  # noqa: BLE001 - surfaced to the UI
                    return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            if self.path == "/api/config/list":
                d = _config_dir(runs_root)
                return self._json(
                    200,
                    {"configs": sorted(
                        f[:-5] for f in os.listdir(d) if f.endswith(".yaml")
                    )},
                )
            if self.path.startswith("/api/config/get"):
                from urllib.parse import parse_qs, urlparse

                import yaml

                q = parse_qs(urlparse(self.path).query)
                p = _safe_config_path(
                    runs_root, q.get("name", [""])[0]
                )
                if p is None or not os.path.exists(p):
                    return self._json(404, {"error": "no such config"})
                with open(p) as f:
                    return self._json(200, {"config": yaml.safe_load(f)})
            if self.path.startswith("/api/log"):
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                run = q.get("run", [runner.status.get("output_dir", "")])[0]
                # constrain to the runs root (no path traversal)
                full = os.path.realpath(run)
                roots = (os.path.realpath(runs_root), os.path.realpath("."))
                if not any(full.startswith(r + os.sep) or full == r for r in roots):
                    return self._json(400, {"error": "run outside runs root"})
                return self._json(200, {"records": _read_log(full)})
            if self.path == "/api/runs":
                runs = []
                if os.path.isdir(runs_root):
                    for name in sorted(os.listdir(runs_root)):
                        d = os.path.join(runs_root, name)
                        if os.path.exists(os.path.join(d, "trainer_log.jsonl")):
                            runs.append(d)
                return self._json(200, {"runs": runs})
            if self.path.startswith("/api/checkpoints"):
                # LlamaBoard's checkpoint dropdown role: list the steps of a
                # run's checkpoints (step_<n>.pt) so the UI can offer resume
                from urllib.parse import parse_qs, urlparse

                from ..utils.checkpoint import list_steps

                q = parse_qs(urlparse(self.path).query)
                run = q.get("run", [""])[0]
                full = os.path.realpath(os.path.join(run, "checkpoints"))
                roots = (os.path.realpath(runs_root), os.path.realpath("."))
                if not any(
                    full.startswith(r + os.sep) or full == r for r in roots
                ):
                    return self._json(400, {"error": "run outside runs root"})
                steps = list_steps(full)
                return self._json(200, {"dir": full, "steps": steps})
            self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                return self._json(400, {"error": str(e)})
            if self.path == "/api/train":
                res = runner.start(req)
                return self._json(400 if "error" in res else 200, res)
            if self.path == "/api/abort":
                return self._json(200, runner.abort())
            if self.path == "/api/export":
                res = exporter.start(req)
                return self._json(400 if "error" in res else 200, res)
            if self.path == "/api/eval":
                res = evaluator.start(req)
                return self._json(400 if "error" in res else 200, res)
            if self.path == "/api/chat/load":
                res = chatter.load(req)
                return self._json(400 if "error" in res else 200, res)
            if self.path == "/api/chat":
                res = chatter.chat(req)
                return self._json(400 if "error" in res else 200, res)
            if self.path == "/api/preview":
                # LlamaBoard's "preview command" role (webui/runner.py
                # _parse_train_args → gen_cmd): the exact yaml that /api/train
                # would run, plus the equivalent CLI invocation
                import yaml

                cfg = req.get("config", req)
                y = yaml.safe_dump(cfg, sort_keys=True, allow_unicode=True)
                name = str(req.get("name", "board_run")) or "board_run"
                path = os.path.join(_config_dir(runs_root), f"{name}.yaml")
                return self._json(
                    200,
                    {
                        "yaml": y,
                        "command": f"python -m infinitevl_tpu_torch.cli train {path}",
                    },
                )
            if self.path == "/api/config/save":
                import yaml

                p = _safe_config_path(runs_root, str(req.get("name", "")))
                if p is None:
                    return self._json(400, {"error": "bad config name"})
                with open(p, "w") as f:
                    yaml.safe_dump(req.get("config", {}), f)
                return self._json(200, {"ok": True, "path": p})
            self._json(404, {"error": "not found"})

    return Handler


def create_board_server(host="0.0.0.0", port=7860, runs_root="output",
                        device: Optional[Device] = None):
    """The board's HTTP server (not yet serving). `device` is resolved once
    and every runner works on it: the CUDA card by default (raises where
    there is none), the CPU's plain versions with device="cpu"."""
    device = resolve_device(device)
    runner = TrainRunner(device)
    exporter, evaluator, chatter = ExportRunner(device), EvalRunner(device), ChatRunner(device)
    server = ThreadingHTTPServer(
        (host, port), make_board_handler(runner, runs_root, exporter, evaluator, chatter)
    )
    server.runner = runner  # type: ignore[attr-defined]
    server.chatter = chatter  # type: ignore[attr-defined]
    return server


def run_board(host="0.0.0.0", port=7860, runs_root="output", device: Optional[Device] = None):
    server = create_board_server(host, port, runs_root, device)
    print(f"training board at http://{host}:{server.server_address[1]}/ on {server.runner.device}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


# Single-page board. Chart styling follows the dataviz spec: one metric per
# chart (no shared axes), single 2px series line (slot-1 blue #2a78d6),
# recessive 1px grid (#f0efec), text in ink tokens (#0b0b0b / #52514e) on the
# light surface (#fcfcfb), hover crosshair + tooltip. The charts and the
# progress bar read a record's step from `current_steps`, the key that
# utils/logging.JsonlLogger writes.
_BOARD_HTML = """<!doctype html><html><head><title>InfiniteVL-TPU board</title>
<style>
body{font-family:system-ui,sans-serif;max-width:980px;margin:1.5em auto;
     background:#fcfcfb;color:#0b0b0b}
h2{margin:.2em 0} .sub{color:#52514e;font-size:13px;margin-bottom:1em}
fieldset{border:1px solid #e4e3df;border-radius:6px;margin-bottom:1em}
label{display:inline-block;margin:.25em .9em .25em 0;font-size:13px;color:#52514e}
input,select{font-size:13px;padding:2px 4px}
button{padding:.45em 1.1em;font-size:14px;margin-right:.5em;cursor:pointer}
.tabs{margin:.8em 0;border-bottom:1px solid #e4e3df}
.tabbtn{border:none;background:none;padding:.5em 1em;border-bottom:2px solid
 transparent;color:#52514e}
.tabbtn.active{border-bottom-color:#2a78d6;color:#0b0b0b;font-weight:600}
#status{font-size:13px;color:#52514e;margin:.6em 0}
.chart{margin:10px 0} .chart h4{margin:0 0 2px;font-size:13px;color:#0b0b0b}
svg{background:#fcfcfb;border:1px solid #eeede9;border-radius:4px}
.tip{position:absolute;pointer-events:none;background:#fff;border:1px solid
 #d8d7d2;border-radius:4px;padding:2px 6px;font-size:12px;color:#0b0b0b;
 display:none}
pre{background:#f6f5f2;padding:8px;border-radius:4px;font-size:12px}
</style></head><body>
<h2>InfiniteVL-TPU board
<select id=lang_sel onchange=setLang(this.value)
 style="float:right;font-size:13px"><option value=en>en</option>
 <option value=zh>zh</option></select></h2>
<div class=sub data-i18n=subtitle>train / evaluate / chat / export; metrics stream from trainer_log.jsonl</div>
<div class=tabs>
<button class="tabbtn active" onclick="showTab('train',this)" data-i18n=tab_train>Train</button>
<button class=tabbtn onclick="showTab('eval',this)" data-i18n=tab_eval>Evaluate</button>
<button class=tabbtn onclick="showTab('chat',this)" data-i18n=tab_chat>Chat</button>
<button class=tabbtn onclick="showTab('export',this)" data-i18n=tab_export>Export</button>
</div>
<div id=tab_train class=tab>
<fieldset><legend data-i18n=leg_model>model</legend>
<label>preset <select id=config_preset><option>tiny</option><option>infinitevl_3b</option></select></label>
<label>checkpoint <input id=model_name_or_path placeholder="(blank = random init)" size=22></label>
<label>rope_scaling <select id=rope_scaling><option value="">none</option>
 <option>linear</option><option>dynamic</option><option>yarn</option><option>llama3</option></select></label>
<label>quant <select id=quantization_bit><option value="">bf16</option><option value=8>int8 (QLoRA)</option></select></label>
</fieldset>
<fieldset><legend data-i18n=leg_data>data</legend>
<label>dataset <input id=dataset value=demo size=12 list=dataset_names
 title="comma-separated list mixes datasets"></label>
<datalist id=dataset_names></datalist>
<label>dataset_dir <input id=dataset_dir value=data size=8></label>
<label>template <select id=template></select></label>
<label>cutoff <input id=cutoff_len value=1024 size=6></label>
<label>max_samples <input id=max_samples size=6 placeholder="all"></label>
<label>mix <select id=mix_strategy><option>concat</option>
 <option>interleave_under</option><option>interleave_over</option></select></label>
<label><input type=checkbox id=packing> packing</label>
<button onclick=previewData() data-i18n=btn_preview_data>Preview dataset</button>
</fieldset>
<fieldset><legend data-i18n=leg_train>train</legend>
<label>stage <select id=stage>
 <option>sft</option><option>pt</option><option>dt</option><option>rm</option>
 <option>dpo</option><option>kto</option><option>ppo</option></select></label>
<label>finetuning <select id=finetuning_type><option>full</option><option>lora</option><option>freeze</option></select></label>
<label>lora_rank <input id=lora_rank value=8 size=3></label>
<label>lora_alpha <input id=lora_alpha value=16 size=3></label>
<label>lora_dropout <input id=lora_dropout value=0 size=4></label>
<label><input type=checkbox id=use_dora> DoRA</label>
<label><input type=checkbox id=use_rslora> rsLoRA</label>
<label>lr <input id=learning_rate value=1e-4 size=7></label>
<label>batch <input id=per_device_train_batch_size value=1 size=3></label>
<label>grad_accum <input id=gradient_accumulation_steps value=1 size=3></label>
<label>epochs <input id=num_train_epochs value=1 size=3></label>
<label>max_steps <input id=max_steps value=100 size=6></label>
<label>output_dir <input id=output_dir value=output/board_run size=16></label>
<label><input type=checkbox id=bf16 checked> bf16</label>
<label><input type=checkbox id=remat> remat</label>
<label><input type=checkbox id=scan_layers> scan_layers</label>
<label><input type=checkbox id=streaming> streaming</label>
<label>val_size <input id=val_size value=0 size=4></label>
<label>eval_steps <input id=eval_steps size=4 placeholder="(end)"></label>
<label>resume <input id=resume_from_checkpoint size=18
 placeholder="(dir or auto)"></label>
<button onclick=useLastRun() data-i18n=btn_last_run>Use last run</button>
</fieldset>
<fieldset><legend data-i18n=leg_advanced>advanced</legend>
<label>scheduler <select id=lr_scheduler_type><option>cosine</option>
 <option>linear</option><option>constant</option></select></label>
<label>warmup <input id=warmup_steps value=0 size=4></label>
<label>weight_decay <input id=weight_decay value=0.01 size=5></label>
<label>max_grad_norm <input id=max_grad_norm value=1.0 size=4></label>
<label>save_steps <input id=save_steps value=5000 size=6></label>
<label>seed <input id=seed value=42 size=4></label>
<label>optimizer <select id=use_optimizer><option value="">adamw</option>
 <option>galore</option><option>apollo</option><option>loraplus</option>
 <option>badam</option><option>adam_mini</option></select></label>
<label>opt_rank <input id=optimizer_rank value=8 size=3></label>
<label>dp <input id=data_parallel value=1 size=2></label>
<label>mp <input id=model_parallel value=1 size=2></label>
<label>param_mode <select id=param_mode><option>fsdp</option>
 <option>tp</option><option>replicated</option></select></label>
<label>report_to <select id=report_to><option value="">none</option>
 <option>tensorboard</option></select></label>
</fieldset>
<fieldset><legend data-i18n=leg_stage>stage-specific (dpo/kto &middot; dt &middot; freeze)</legend>
<label>pref_beta <input id=pref_beta value=0.1 size=4></label>
<label>pref_loss <select id=pref_loss><option>sigmoid</option><option>ipo</option>
 <option>simpo</option><option>orpo</option></select></label>
<label>distill_stage <select id=distill_stage><option>1</option><option>2</option></select></label>
<label>mse_factor <input id=mse_factor value=1000 size=6></label>
<label>distill_T <input id=distill_temperature value=2.0 size=4></label>
<label>teacher <input id=teacher_model_path size=16 placeholder="(dt stage)"></label>
<label>freeze_layers <input id=freeze_trainable_layers value=2 size=3></label>
</fieldset>
<fieldset><legend data-i18n=leg_saved>saved configs</legend>
<label>name <input id=cfg_name value=my_run size=12></label>
<button onclick=saveCfg() data-i18n=btn_save>Save</button>
<select id=cfg_list></select>
<button onclick=loadCfg() data-i18n=btn_load>Load</button>
<span id=cfg_status></span>
</fieldset>
<button onclick=preview() data-i18n=btn_preview>Preview YAML</button>
<button onclick=start() data-i18n=btn_start>Start</button>
<button onclick=abortRun() data-i18n=btn_abort>Abort</button>
<div id=status>idle</div>
<div id=prog_wrap style="display:none;margin:.4em 0;max-width:600px">
<div style="background:#eeede9;border-radius:4px;height:10px;overflow:hidden">
<div id=prog_bar style="background:#2a78d6;height:10px;width:0%"></div></div>
<span id=prog_text style="font-size:12px;color:#52514e"></span></div>
<pre id=yaml style="display:none"></pre>
<pre id=data_preview style="display:none"></pre>
<div id=charts></div>
</div>
<div id=tab_eval class=tab style="display:none">
<fieldset><legend data-i18n=leg_eval>evaluate &amp; predict (MCQ accuracy or SFT BLEU/ROUGE)</legend>
<label>mode <select id=ev_mode><option value=mcq>MCQ accuracy</option>
 <option value=predict>SFT predict (BLEU/ROUGE)</option></select></label>
<label>checkpoint <input id=ev_model_path placeholder="(blank = random init)" size=22></label>
<label>preset <select id=ev_preset><option>tiny</option><option>infinitevl_3b</option></select></label>
<label>dataset <input id=ev_dataset value=mcq_demo size=12 list=dataset_names></label>
<label>dataset_dir <input id=ev_dir value=data size=8></label>
<label>n_shot <input id=ev_nshot value=5 size=3></label>
<label>batch <input id=ev_batch value=4 size=3></label>
<label>samples <input id=ev_samples value=16 size=4></label>
<label>lang <select id=ev_lang><option>en</option><option>zh</option></select></label>
<button onclick=doEval() data-i18n=btn_eval>Evaluate</button>
<span id=ev_status></span>
</fieldset>
<table id=ev_table style="display:none;font-size:13px;border-collapse:collapse">
<thead><tr><th style="text-align:left;padding:4px 12px 4px 0">subject</th>
<th style="text-align:right">accuracy</th></tr></thead><tbody></tbody></table>
</div>
<div id=tab_chat class=tab style="display:none">
<fieldset><legend data-i18n=leg_load>load model</legend>
<label>checkpoint <input id=ch_model_path placeholder="(blank = random init)" size=22></label>
<label>preset <select id=ch_preset><option>tiny</option><option>infinitevl_3b</option></select></label>
<label>template <select id=ch_template></select></label>
<label>quant <select id=ch_quant><option value="">bf16</option><option value=8>int8</option><option value=4>int4</option></select></label>
<label>spec draft_k <input id=ch_draft value=0 size=3
 title="0 = off; >0 enables lossless prompt-lookup speculation for greedy text chats"></label>
<button onclick=loadChat() data-i18n=btn_load_chat>Load</button>
<span id=ch_status>empty</span>
</fieldset>
<div style="margin:6px 0"><label>system prompt
 <input id=ch_system size=60 placeholder="(optional)"></label></div>
<div id=ch_log style="border:1px solid #e4e3df;border-radius:6px;min-height:120px;
 padding:8px;font-size:14px;white-space:pre-wrap"></div>
<div style="margin-top:8px">
<input id=ch_input size=70 placeholder="message..." onkeydown="if(event.key==='Enter')sendChat()">
<button onclick=sendChat() data-i18n=btn_send>Send</button>
<button onclick="CHAT.length=0;IMGS.length=0;renderChat()" data-i18n=btn_clear>Clear</button>
<label>image <input type=file id=ch_image accept="image/*"></label>
<label>max_new <input id=ch_max value=128 size=4></label>
<label>temp <input id=ch_temp value=0 size=4></label>
<label>top_p <input id=ch_top_p value=1.0 size=4></label>
<label>top_k <input id=ch_top_k value=0 size=4></label>
</div>
</div>
<div id=tab_export class=tab style="display:none">
<fieldset><legend data-i18n=leg_export>export (HF safetensors + ollama Modelfile)</legend>
<label>checkpoint <input id=exp_model_path placeholder="(blank = random init)" size=22></label>
<label>preset <select id=exp_preset><option>tiny</option><option>infinitevl_3b</option></select></label>
<label>template <select id=exp_template></select></label>
<label>output_dir <input id=exp_out value=output/export size=16></label>
<button onclick=doExport() data-i18n=btn_export>Export</button>
<span id=exp_status></span>
</fieldset>
</div>
<div id=tip class=tip></div>
<script>
// i18n: en/zh label dictionary (reference webui/locales.py role; knob ids
// stay english — they ARE the yaml keys, same as LlamaBoard's elem_ids)
const I18N={
 en:{subtitle:"train / evaluate / chat / export; metrics stream from trainer_log.jsonl",
  tab_train:"Train",tab_eval:"Evaluate",tab_chat:"Chat",tab_export:"Export",
  leg_model:"model",leg_data:"data",leg_train:"train",leg_advanced:"advanced",
  leg_stage:"stage-specific (dpo/kto \u00b7 dt \u00b7 freeze)",
  leg_saved:"saved configs",
  leg_eval:"evaluate & predict (MCQ accuracy or SFT BLEU/ROUGE)",
  leg_load:"load model",leg_export:"export (HF safetensors + ollama Modelfile)",
  btn_preview_data:"Preview dataset",btn_last_run:"Use last run",
  btn_preview:"Preview YAML",btn_start:"Start",btn_abort:"Abort",
  btn_save:"Save",btn_load:"Load",btn_eval:"Evaluate",btn_load_chat:"Load",
  btn_send:"Send",btn_clear:"Clear",btn_export:"Export"},
 zh:{subtitle:"\u8bad\u7ec3 / \u8bc4\u4f30 / \u5bf9\u8bdd / \u5bfc\u51fa\uff1b\u6307\u6807\u6765\u81ea trainer_log.jsonl",
  tab_train:"\u8bad\u7ec3",tab_eval:"\u8bc4\u4f30",tab_chat:"\u5bf9\u8bdd",tab_export:"\u5bfc\u51fa",
  leg_model:"\u6a21\u578b",leg_data:"\u6570\u636e",leg_train:"\u8bad\u7ec3\u53c2\u6570",
  leg_advanced:"\u9ad8\u7ea7\u8bbe\u7f6e",
  leg_stage:"\u9636\u6bb5\u4e13\u5c5e (dpo/kto \u00b7 dt \u00b7 freeze)",
  leg_saved:"\u5df2\u5b58\u914d\u7f6e",
  leg_eval:"\u8bc4\u4f30\u4e0e\u9884\u6d4b\uff08MCQ \u51c6\u786e\u7387\u6216 BLEU/ROUGE\uff09",
  leg_load:"\u52a0\u8f7d\u6a21\u578b",
  leg_export:"\u5bfc\u51fa\uff08HF safetensors + ollama Modelfile\uff09",
  btn_preview_data:"\u9884\u89c8\u6570\u636e\u96c6",btn_last_run:"\u4f7f\u7528\u4e0a\u6b21\u8fd0\u884c",
  btn_preview:"\u9884\u89c8 YAML",btn_start:"\u5f00\u59cb",btn_abort:"\u4e2d\u6b62",
  btn_save:"\u4fdd\u5b58",btn_load:"\u52a0\u8f7d",btn_eval:"\u8bc4\u4f30",
  btn_load_chat:"\u52a0\u8f7d",btn_send:"\u53d1\u9001",btn_clear:"\u6e05\u7a7a",
  btn_export:"\u5bfc\u51fa"}};
function setLang(l){localStorage.setItem("ivl_lang",l);
 const d=I18N[l]||I18N.en;
 for(const el of document.querySelectorAll("[data-i18n]")){
  const t=d[el.getAttribute("data-i18n")];if(t!==undefined)el.textContent=t;}}
window.addEventListener("DOMContentLoaded",()=>{
 const l=localStorage.getItem("ivl_lang")||"en";
 document.getElementById("lang_sel").value=l;setLang(l);});
function showTab(name,btn){for(const t of document.querySelectorAll(".tab"))t.style.display="none";
 document.getElementById("tab_"+name).style.display="block";
 for(const b of document.querySelectorAll(".tabbtn"))b.classList.remove("active");
 btn.classList.add("active");}
const FORM=["stage","config_preset","dataset","dataset_dir","finetuning_type",
 "learning_rate","per_device_train_batch_size","cutoff_len","max_steps","output_dir",
 "template","lora_rank","lora_alpha","lora_dropout","gradient_accumulation_steps",
 "num_train_epochs","mix_strategy","lr_scheduler_type","warmup_steps","weight_decay",
 "max_grad_norm","save_steps","seed","optimizer_rank","data_parallel","model_parallel",
 "param_mode","pref_beta","pref_loss","distill_stage","mse_factor",
 "distill_temperature","freeze_trainable_layers","val_size"];
const NUM=new Set(["learning_rate","per_device_train_batch_size","cutoff_len",
 "max_steps","lora_rank","lora_alpha","lora_dropout","gradient_accumulation_steps",
 "num_train_epochs","warmup_steps","weight_decay","max_grad_norm","save_steps",
 "seed","optimizer_rank","data_parallel","model_parallel","pref_beta",
 "distill_stage","mse_factor","distill_temperature","freeze_trainable_layers",
 "val_size"]);
const CHECKS=["bf16","packing","remat","scan_layers","use_dora","use_rslora",
 "streaming"];
const OPT=["model_name_or_path","rope_scaling","quantization_bit","max_samples",
 "use_optimizer","teacher_model_path","resume_from_checkpoint","eval_steps",
 "report_to"];
function cfg(){const c={};for(const k of FORM){let v=document.getElementById(k).value;
 if(NUM.has(k))v=Number(v);c[k]=v;}
 for(const k of CHECKS)c[k]=document.getElementById(k).checked;
 for(const k of OPT){const v=document.getElementById(k).value;
  if(v)c[k]=(k==="quantization_bit"||k==="max_samples"||k==="eval_steps")?Number(v):v;}
 c.logging_steps=1;return c;}
async function useLastRun(){const j=await (await fetch("/api/runs")).json();
 if(j.runs&&j.runs.length)
  document.getElementById("resume_from_checkpoint").value=
   j.runs[j.runs.length-1]+"/checkpoints";}
async function preview(){
 const r=await fetch("/api/preview",{method:"POST",
  headers:{"Content-Type":"application/json"},
  body:JSON.stringify({name:document.getElementById("cfg_name").value,config:cfg()})});
 const j=await r.json();
 const el=document.getElementById("yaml");
 el.textContent=j.error?("error: "+j.error):("# "+j.command+"\\n"+j.yaml);
 el.style.display="block";}
async function previewData(){
 const q=new URLSearchParams({name:document.getElementById("dataset").value,
  dir:document.getElementById("dataset_dir").value,
  template:document.getElementById("template").value});
 const j=await (await fetch("/api/dataset?"+q)).json();
 const el=document.getElementById("data_preview");
 el.textContent=j.error?("error: "+j.error):
  j.examples.map(e=>e.rendered).join("\\n----------------\\n");
 el.style.display="block";}
async function saveCfg(){
 const r=await fetch("/api/config/save",{method:"POST",
  headers:{"Content-Type":"application/json"},
  body:JSON.stringify({name:document.getElementById("cfg_name").value,config:cfg()})});
 const j=await r.json();
 document.getElementById("cfg_status").textContent=j.error||"saved";loadCfgList();}
async function loadCfgList(){
 const j=await (await fetch("/api/config/list")).json();
 document.getElementById("cfg_list").innerHTML=
  (j.configs||[]).map(c=>`<option>${c}</option>`).join("");}
async function loadCfg(){
 const name=document.getElementById("cfg_list").value;if(!name)return;
 const j=await (await fetch("/api/config/get?name="+encodeURIComponent(name))).json();
 if(j.error){document.getElementById("cfg_status").textContent=j.error;return;}
 const c=j.config||{};
 for(const k of FORM)if(c[k]!==undefined)document.getElementById(k).value=c[k];
 for(const k of CHECKS)if(c[k]!==undefined)document.getElementById(k).checked=c[k];
 for(const k of OPT)document.getElementById(k).value=c[k]!==undefined?c[k]:"";
 document.getElementById("cfg_status").textContent="loaded "+name;}
async function start(){const r=await fetch("/api/train",{method:"POST",
 headers:{"Content-Type":"application/json"},body:JSON.stringify(cfg())});
 const j=await r.json();
 document.getElementById("status").textContent=j.error?("error: "+j.error):("running -> "+j.output_dir);}
async function abortRun(){await fetch("/api/abort",{method:"POST",body:"{}"});}
async function doEval(){
 const c={mode:document.getElementById("ev_mode").value,
  config_preset:document.getElementById("ev_preset").value,
  dataset:document.getElementById("ev_dataset").value,
  dataset_dir:document.getElementById("ev_dir").value,
  n_shot:Number(document.getElementById("ev_nshot").value),
  eval_batch_size:Number(document.getElementById("ev_batch").value),
  predict_samples:Number(document.getElementById("ev_samples").value),
  lang:document.getElementById("ev_lang").value};
 if(c.mode==="predict")c.output_dir="output/board_predict";
 const mp=document.getElementById("ev_model_path").value;if(mp)c.model_name_or_path=mp;
 const r=await fetch("/api/eval",{method:"POST",
  headers:{"Content-Type":"application/json"},body:JSON.stringify(c)});
 const j=await r.json();
 document.getElementById("ev_status").textContent=j.error||"running...";
 if(!j.error)pollEval();}
async function pollEval(){
 const s=await (await fetch("/api/eval/status")).json();
 document.getElementById("ev_status").textContent=s.state+(s.error?" | "+s.error:"");
 if(s.state==="running"){setTimeout(pollEval,2000);return;}
 if(s.state==="done"&&s.results){
  // MCQ metrics are fractions in [0,1]; predict metrics (BLEU/ROUGE)
  // are already [0,100]-scaled and 'samples' is a count
  const predict=document.getElementById("ev_mode").value==="predict";
  const fmt=(k,v)=>predict?(k==="samples"?v:v.toFixed(2)):
   (100*v).toFixed(1)+"%";
  const tb=document.querySelector("#ev_table tbody");
  tb.innerHTML=Object.entries(s.results).sort().map(([k,v])=>
   `<tr><td style="padding:2px 12px 2px 0">${k}</td>
    <td style="text-align:right">${fmt(k,v)}</td></tr>`).join("");
  document.getElementById("ev_table").style.display="table";}}
const CHAT=[];const IMGS=[];
function renderChat(){document.getElementById("ch_log").textContent=
 CHAT.map(m=>(m.role==="user"?"You: ":"Model: ")+m.content).join("\\n");}
async function loadChat(){
 const c={config_preset:document.getElementById("ch_preset").value,
  template:document.getElementById("ch_template").value};
 const mp=document.getElementById("ch_model_path").value;if(mp)c.model_name_or_path=mp;
 const qb=document.getElementById("ch_quant").value;if(qb)c.quantization_bit=Number(qb);
 const dk=Number(document.getElementById("ch_draft").value);if(dk)c.draft_k=dk;
 const r=await fetch("/api/chat/load",{method:"POST",
  headers:{"Content-Type":"application/json"},body:JSON.stringify(c)});
 const j=await r.json();
 document.getElementById("ch_status").textContent=j.error||"loading...";
 if(!j.error)pollChatLoad();}
async function pollChatLoad(){
 const s=await (await fetch("/api/chat/status")).json();
 document.getElementById("ch_status").textContent=s.state+(s.error?" | "+s.error:"");
 if(s.state==="loading")setTimeout(pollChatLoad,2000);}
function readImage(){return new Promise(res=>{
 const f=document.getElementById("ch_image").files[0];
 if(!f){res(null);return;}
 const rd=new FileReader();rd.onload=()=>res(rd.result);rd.readAsDataURL(f);});}
async function sendChat(){
 const inp=document.getElementById("ch_input");let text=inp.value.trim();
 if(!text)return;inp.value="";
 const img=await readImage();
 if(img){text="<image>"+text;  // ChatModel expands the marker to vision pads
  IMGS.push(img);document.getElementById("ch_image").value="";}
 CHAT.push({role:"user",content:text});renderChat();
 const body={messages:CHAT,
  system:document.getElementById("ch_system").value,
  max_new_tokens:Number(document.getElementById("ch_max").value),
  temperature:Number(document.getElementById("ch_temp").value),
  top_p:Number(document.getElementById("ch_top_p").value),
  top_k:Number(document.getElementById("ch_top_k").value)};
 // chat is stateless server-side: every <image> marker in the history
 // needs its pixels re-sent, in order
 if(IMGS.length)body.images=IMGS;
 const r=await fetch("/api/chat",{method:"POST",
  headers:{"Content-Type":"application/json"},body:JSON.stringify(body)});
 const j=await r.json();
 CHAT.push({role:"assistant",content:j.error?("[error: "+j.error+"]"):j.content});
 renderChat();}
async function fillTemplates(){
 const j=await (await fetch("/api/templates")).json();
 const opts=(j.templates||["qwen2_vl"]).map(t=>`<option>${t}</option>`).join("");
 for(const id of ["template","ch_template","exp_template"]){
  const el=document.getElementById(id);el.innerHTML=opts;el.value="qwen2_vl";}}
async function fillDatasets(){
 const dir=document.getElementById("dataset_dir").value||"data";
 const j=await (await fetch("/api/datasets?dir="+encodeURIComponent(dir))).json();
 document.getElementById("dataset_names").innerHTML=
  (j.datasets||[]).map(d=>`<option value="${d.name}">`).join("");}
fillTemplates();loadCfgList();fillDatasets();
document.getElementById("dataset_dir").addEventListener("change",fillDatasets);
async function doExport(){
 const c={config_preset:document.getElementById("exp_preset").value,
  template:document.getElementById("exp_template").value,
  output_dir:document.getElementById("exp_out").value};
 const mp=document.getElementById("exp_model_path").value;
 if(mp)c.model_name_or_path=mp;
 const r=await fetch("/api/export",{method:"POST",
  headers:{"Content-Type":"application/json"},body:JSON.stringify(c)});
 const j=await r.json();
 document.getElementById("exp_status").textContent=j.error||("started -> "+j.output_dir);
 pollExport();}
async function pollExport(){
 const s=await (await fetch("/api/export/status")).json();
 document.getElementById("exp_status").textContent=
  s.state+(s.error?" | "+s.error:"")+(s.state==="done"?" -> "+s.output_dir:"");
 if(s.state==="running")setTimeout(pollExport,2000);}
function chart(name,pts){
 const W=940,H=150,P=36;const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
 const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
 const sx=s=>P+(x1>x0?(s-x0)/(x1-x0):0)*(W-2*P), sy=v=>H-24-(y1>y0?(v-y0)/(y1-y0):0.5)*(H-40);
 let g="";for(let i=0;i<4;i++){const yy=16+i*(H-40)/3;
  g+=`<line x1=${P} y1=${yy} x2=${W-8} y2=${yy} stroke="#f0efec"/>`
   + `<text x=4 y=${yy+4} font-size=10 fill="#52514e">${(y1-(y1-y0)*i/3).toPrecision(3)}</text>`;}
 const path=pts.map((p,i)=>(i?"L":"M")+sx(p[0]).toFixed(1)+","+sy(p[1]).toFixed(1)).join(" ");
 // EMA-smoothed overlay (LlamaBoard's gen_loss_plot smoothing role):
 // raw series recedes to 35% opacity once there is enough data to smooth
 let smooth="";
 if(pts.length>5){let m=pts[0][1];
  const sp=pts.map((p,i)=>{m=0.6*m+0.4*p[1];
   return (i?"L":"M")+sx(p[0]).toFixed(1)+","+sy(m).toFixed(1);}).join(" ");
  smooth=`<path d="${sp}" fill=none stroke="#2a78d6" stroke-width=2
   stroke-linejoin=round stroke-linecap=round/>`;}
 return `<div class=chart><h4>${name}</h4>
 <svg width=${W} height=${H} data-n="${name}" data-pts='${JSON.stringify(pts)}'>
 ${g}<path d="${path}" fill=none stroke="#2a78d6"
  stroke-width=${smooth?1.5:2} opacity=${smooth?0.35:1}
  stroke-linejoin=round stroke-linecap=round/>${smooth}
 <text x=${P} y=${H-6} font-size=10 fill="#52514e">step ${x0}</text>
 <text x=${W-60} y=${H-6} font-size=10 fill="#52514e">step ${x1}</text>
 <circle r=4 fill="#2a78d6" stroke="#fcfcfb" stroke-width=2 style="display:none"/>
 </svg></div>`;}
async function poll(){
 const st=await (await fetch("/api/status")).json();
 if(st.output_dir){
  const j=await (await fetch("/api/log?run="+encodeURIComponent(st.output_dir))).json();
  const recs=j.records||[];const metrics={};
  for(const r of recs)for(const k in r)if(k!=="step"&&typeof r[k]==="number")
   (metrics[k]=metrics[k]||[]).push([r.current_steps,r[k]]);
  document.getElementById("charts").innerHTML=
   Object.entries(metrics).map(([k,v])=>chart(k,v)).join("");
  hookHover();
  const last=recs[recs.length-1];
  document.getElementById("status").textContent=
   (st.running?"running":"done")+(st.error?" | "+st.error:"")
   +(last?` | step ${last.current_steps}`+(last.loss!==undefined?` loss ${last.loss}`:""):"");
  // progress bar + ETA (LlamaBoard runner progress / get_trainer_info role):
  // fraction from max_steps + last logged step; ETA from started_at rate
  const wrap=document.getElementById("prog_wrap");
  if(st.max_steps&&last&&last.current_steps){
   const frac=Math.min(1,last.current_steps/st.max_steps);
   document.getElementById("prog_bar").style.width=(100*frac).toFixed(1)+"%";
   let eta="";
   if(st.running&&st.started_at&&frac>0&&frac<1){
    const el=Date.now()/1000-st.started_at;
    eta=` | eta ${Math.round(el/frac-el)}s`;}
   document.getElementById("prog_text").textContent=
    `${last.current_steps} / ${st.max_steps} (${(100*frac).toFixed(0)}%)`+eta;
   wrap.style.display="block";
  } else wrap.style.display="none";
 }
 setTimeout(poll,2000);}
function hookHover(){const tip=document.getElementById("tip");
 for(const svg of document.querySelectorAll("svg")){
  const pts=JSON.parse(svg.dataset.pts);const dot=svg.querySelector("circle");
  svg.onmousemove=e=>{const r=svg.getBoundingClientRect();
   const fx=(e.clientX-r.left-36)/(r.width-44);
   const i=Math.max(0,Math.min(pts.length-1,Math.round(fx*(pts.length-1))));
   const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
   const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
   const cx=36+(x1>x0?(pts[i][0]-x0)/(x1-x0):0)*(r.width-44);
   const cy=150-24-(y1>y0?(pts[i][1]-y0)/(y1-y0):0.5)*(150-40);
   dot.setAttribute("cx",cx);dot.setAttribute("cy",cy);dot.style.display="block";
   tip.style.display="block";tip.style.left=(e.pageX+12)+"px";tip.style.top=(e.pageY-10)+"px";
   tip.textContent=`step ${pts[i][0]}: ${pts[i][1]}`;};
  svg.onmouseleave=()=>{dot.style.display="none";tip.style.display="none";};}}
poll();
</script></body></html>"""
