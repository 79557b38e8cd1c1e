"""The port stands alone: it never loads jax nor anything of the JAX
package, its configs are its own copy of the JAX package's (held field by
field), and chip_smoke.py refuses to run (non-zero exit, no result line)
without a CUDA card or outside a checkout. The import checks run in a
fresh interpreter."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from torch_port_helpers import to_port_config

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "infinitevl_tpu_torch"
ENV = {**os.environ, "PYTHONPATH": str(REPO)}

NO_JAX_PROGRAM = r"""
import importlib, pkgutil, sys
import numpy as np, torch
import infinitevl_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from infinitevl_tpu_torch.config import tiny_config
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.params import init_text_params
torch.set_num_threads(1)
cfg = tiny_config()
params = {"text": init_text_params(cfg.text, torch.Generator().manual_seed(0), "cpu",
                                   torch.float32)}
out = Generator(params, cfg, device="cpu").generate(np.arange(20)[None] % 400, max_new_tokens=3)
assert out.shape == (1, 3), out.shape
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", loaded)
"""

# every module of the port, then chip_smoke.py as a module (its phases import
# the port inside functions, so they are named here too)
NOTHING_OF_JAX_PROGRAM = r"""
import importlib, importlib.util, pkgutil, sys
import infinitevl_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for needed in ("config", "device", "streaming", "generation", "data.processing",
               "models.vision", "models.infinitevl", "ops.vit_flash", "ops.vit_kernels",
               "ops.delta_kernels", "ops.int4_kernels", "models.quant", "models.fuse",
               "speculative", "beam", "serve.batching", "serve.chat", "serve.api",
               "data.template", "data.loader", "hparams", "utils.logging",
               "utils.checkpoint", "train.step", "train.lora", "train.trainer",
               "eval.text_metrics", "ops.swa_kernels", "cli", "eval.mcq",
               "models.convert", "train.distill", "utils.safetensors_io", "train.dpo",
               "train.ppo", "train.optim", "ops.mamba2", "parallel.sharding",
               "parallel.launch", "data.mm_plugin", "native", "serve.webui",
               "utils.profiling"):
    assert pkg.__name__ + "." + needed in names, needed
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "infinitevl_tpu" or m.startswith("infinitevl_tpu."))
print("FOREIGN_MODULES", bad)
"""


TRAINING_PROGRAM = r"""
import sys, tempfile
import torch
import infinitevl_tpu_torch.train.trainer as trainer
from infinitevl_tpu_torch.hparams import load_yaml_args
torch.set_num_threads(1)
args = load_yaml_args("examples/sft_tiny.yaml")
args.train.output_dir = tempfile.mkdtemp()
args.train.max_steps = 2
args.finetune.finetuning_type = "lora"
final = trainer.run_sft(args, device="cpu")
assert "kernel" in final["text"]["layers"][0]["q_proj"]
try:
    trainer.run_sft(args)  # no device named: the card, and there is none here
except RuntimeError as e:
    assert "CUDA" in str(e), e
else:
    raise AssertionError("run_sft defaulted to the CPU")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "infinitevl_tpu"))
print("FOREIGN_MODULES", bad)
"""


CHECKPOINT_PROGRAM = r"""
import sys, tempfile, os
import torch
import infinitevl_tpu_torch.train.trainer as trainer
from infinitevl_tpu_torch.cli import cmd_export
from infinitevl_tpu_torch.config import tiny_config
from infinitevl_tpu_torch.hparams import load_yaml_args
from infinitevl_tpu_torch.models.params import init_params, load_hf_checkpoint
from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors
torch.set_num_threads(1)
cfg = tiny_config()
d = tempfile.mkdtemp()
export_hf_safetensors(init_params(cfg, torch.Generator().manual_seed(0), "cpu"), cfg, d + "/t")
load_hf_checkpoint(d + "/t", cfg, device="cpu")
for name in ("dt_stage1_tiny", "dt_stage1_mamba2_tiny"):
    args = load_yaml_args(f"examples/{name}.yaml")
    args.train.output_dir, args.train.max_steps = f"{d}/{name}", 1
    trainer.run_exp(args, device="cpu")
with open(d + "/e.yaml", "w") as f:
    f.write(f"config_preset: tiny\nmodel_name_or_path: {d}/t\noutput_dir: {d}/e\n")
cmd_export(d + "/e.yaml", device="cpu")
assert os.path.exists(d + "/e/model.safetensors")
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "infinitevl_tpu", "safetensors", "transformers"))
print("FOREIGN_MODULES", bad)
"""


PREFERENCE_PROGRAM = r"""
import sys, tempfile
import torch
import infinitevl_tpu_torch.train.trainer as trainer
from infinitevl_tpu_torch.hparams import load_yaml_args
torch.set_num_threads(1)
d = tempfile.mkdtemp()
for name in ("rm", "dpo", "kto", "ppo"):
    args = load_yaml_args(f"examples/{name}_tiny.yaml")
    args.train.output_dir, args.train.max_steps = f"{d}/{name}", 1
    args.finetune.reward_model_path = f"{d}/rm/checkpoints"
    trainer.run_exp(args, device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "infinitevl_tpu"))
print("FOREIGN_MODULES", bad)
"""


MM_NATIVE_PROGRAM = r"""
import sys
import numpy as np
from infinitevl_tpu_torch import native
from infinitevl_tpu_torch.config import tiny_config
from infinitevl_tpu_torch.data import loader, mm_plugin
rows = [{"messages": [{"role": "user", "content": "<image>What is it?"},
                      {"role": "assistant", "content": "red"}],
         "images": ["images/red_square.png"]}]
for name in ("paligemma", "gemma3"):
    assert mm_plugin.get_mm_plugin(name) is not None
    enc = loader.encode_supervised_mm(rows, loader.SimpleTokenizer(), tiny_config(),
                                      template=name, cutoff_len=2048, dataset_dir="data")
    assert enc[0]["pixel_values"].ndim == 4
if native.available():
    out = native.preprocess_frame(np.zeros((56, 56, 3), np.uint8), (56, 56))
    assert out.shape == (16, 1176), out.shape
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "infinitevl_tpu"))
print("FOREIGN_MODULES", bad)
"""


BOARD_AND_SCRIPTS_PROGRAM = r"""
import importlib.util, json, sys, threading, urllib.request
import torch
from infinitevl_tpu_torch.serve.webui import create_board_server
from infinitevl_tpu_torch.utils import profiling
torch.set_num_threads(1)
server = create_board_server(host="127.0.0.1", port=0, runs_root="/nonexistent", device="cpu")
threading.Thread(target=server.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{server.server_address[1]}/api/status"
assert json.loads(urllib.request.urlopen(url).read()) == {"running": False}
server.shutdown()
twins = {}
for name in ("cal_flops", "cal_mfu", "cal_ppl", "llama_pro", "batch_infer", "length_cdf",
             "prefill_bench", "eval_bleu_rouge"):
    spec = importlib.util.spec_from_file_location(name, f"scripts/torch_{name}.py")
    twins["torch_" + name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twins["torch_" + name])
    assert callable(twins["torch_" + name].main), name
twins["torch_cal_flops"].main()
twins["torch_cal_mfu"].main(tokens_per_sec=4294.0)
twins["torch_length_cdf"].main("examples/sft_tiny.yaml")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "infinitevl_tpu"))
print("FOREIGN_MODULES", bad)
"""


# every program in its own interpreter, all started at once (they share
# nothing); each test waits for its own and reads what it printed
PROGRAMS = {
    "board_and_scripts": (BOARD_AND_SCRIPTS_PROGRAM, {}),
    "mm_native": (MM_NATIVE_PROGRAM, {}),
    "preference": (PREFERENCE_PROGRAM, {}),
    "checkpoint": (CHECKPOINT_PROGRAM, {}),
    "training": (TRAINING_PROGRAM, {"CUDA_VISIBLE_DEVICES": ""}),
    "no_jax": (NO_JAX_PROGRAM, {}),
    "nothing_of_jax": (NOTHING_OF_JAX_PROGRAM, {}),
}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    out = tmp_path_factory.mktemp("programs")
    procs = {}
    for name, (program, env) in PROGRAMS.items():
        with open(out / f"{name}.out", "w") as so, open(out / f"{name}.err", "w") as se:
            procs[name] = subprocess.Popen([sys.executable, "-c", program], cwd=REPO,
                                           env={**ENV, **env}, stdout=so, stderr=se, text=True)
    yield out, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finished(started, name):
    """(exit code, stdout, stderr) of program `name`."""
    out, procs = started
    code = procs[name].wait(timeout=300)
    return code, (out / f"{name}.out").read_text(), (out / f"{name}.err").read_text()


def test_board_profiling_and_script_twins_load_nothing_of_jax(started):
    """`serve/webui`, `utils/profiling` and the eight scripts/torch_*.py twins,
    imported and run (the board answering on the CPU, cal_flops, cal_mfu,
    length_cdf), load neither jax nor the JAX package."""
    code, out, err = _finished(started, "board_and_scripts")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_mm_plugin_and_native_load_nothing_of_jax(started):
    """The paligemma / gemma3 encodings and the native preprocessing load
    neither jax nor the JAX package."""
    code, out, err = _finished(started, "mm_native")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_preference_stages_load_nothing_of_jax(started):
    """rm, dpo, kto and ppo (from the rm checkpoint) through run_exp load
    neither jax, optax nor the JAX package."""
    code, out, err = _finished(started, "preference")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_checkpoint_and_distillation_path_loads_no_safetensors_or_transformers(started):
    """Export, load, a distillation step and `cli export` need neither the
    `safetensors` nor the `transformers` package (the card's machine has
    neither), nor anything of JAX."""
    code, out, err = _finished(started, "checkpoint")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_training_entry_point_loads_nothing_of_jax_and_defaults_to_the_card(started):
    """`import infinitevl_tpu_torch.train.trainer` and a run_sft call load
    neither jax, optax nor the JAX package; with no device named, run_sft
    asks for the CUDA card (and raises where there is none)."""
    code, out, err = _finished(started, "training")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_port_never_loads_jax(started):
    code, out, err = _finished(started, "no_jax")
    assert code == 0, err
    assert "JAX_MODULES []" in out, out


def test_importing_the_port_loads_nothing_of_jax_or_the_jax_package(started):
    code, out, err = _finished(started, "nothing_of_jax")
    assert code == 0, err
    assert "FOREIGN_MODULES []" in out, out


def test_no_jax_import_lines_in_the_port():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import infinitevl_tpu\b|from infinitevl_tpu[. ])", re.M)
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py", *REPO.glob("scripts/torch_*.py")]
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("cls", ["VisionConfig", "TextConfig", "InfiniteVLConfig"])
def test_config_dataclasses_match_field_by_field(cls):
    import infinitevl_tpu.config as jconfig
    import infinitevl_tpu_torch.config as tconfig

    assert tconfig.__file__ != jconfig.__file__
    jf = dataclasses.fields(getattr(jconfig, cls))
    tf = dataclasses.fields(getattr(tconfig, cls))
    assert [f.name for f in tf] == [f.name for f in jf]
    jdef, tdef = getattr(jconfig, cls)(), getattr(tconfig, cls)()
    for f in jf:
        a, b = getattr(jdef, f.name), getattr(tdef, f.name)
        if dataclasses.is_dataclass(a):  # the nested text / vision configs
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for name in ("SLIDING", "FULL", "LINEAR", "MAMBA2"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


@pytest.mark.parametrize("factory", ["infinitevl_3b", "tiny_config"])
def test_config_factories_and_derived_values_match(factory):
    import infinitevl_tpu.config as jconfig
    import infinitevl_tpu_torch.config as tconfig

    jcfg, tcfg = getattr(jconfig, factory)(), getattr(tconfig, factory)()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert to_port_config(jcfg) == tcfg
    for prop in ("linear_key_dim", "linear_value_dim", "head_v_dim", "swa_layer_indices",
                 "linear_layer_indices", "num_swa_layers", "num_linear_layers",
                 "num_mamba2_layers", "swa_capacity"):
        assert getattr(tcfg.text, prop) == getattr(jcfg.text, prop), prop
    assert [tcfg.text.layer_role(i) for i in range(tcfg.text.num_hidden_layers)] == \
        [jcfg.text.layer_role(i) for i in range(jcfg.text.num_hidden_layers)]
    for prop in ("head_dim", "spatial_merge_unit", "merger_window"):
        assert getattr(tcfg.vision, prop) == getattr(jcfg.vision, prop), prop
    assert tcfg.tokens_per_frame_448 == jcfg.tokens_per_frame_448


def test_config_from_hf_dict_matches():
    import infinitevl_tpu.config as jconfig
    import infinitevl_tpu_torch.config as tconfig

    hf = {
        "vocab_size": 1000, "hidden_size": 128, "num_attention_heads": 4,
        "num_hidden_layers": 4, "use_sliding_window": False,
        "max_position_embeddings": 4096, "image_token_id": 990,
        "layer_types": ["sliding_attention", "linear_attention"] * 2,
        "rope_scaling": {"rope_type": "yarn", "factor": 4.0, "mrope_section": [4, 6, 6],
                         "original_max_position_embeddings": 1024},
        "vision_config": {"depth": 2, "hidden_size": 64, "fullatt_block_indexes": [1]},
    }
    assert dataclasses.asdict(tconfig.from_hf_dict(hf)) == \
        dataclasses.asdict(jconfig.from_hf_dict(hf))
    with pytest.raises(ValueError, match="hidden_act"):
        tconfig.VisionConfig(hidden_act="gelu")


_MESSAGES = [
    {"role": "system", "content": "You are terse."},
    {"role": "user", "content": "What is in <image> this\npicture?"},
    {"role": "assistant", "content": "A cat."},
    {"role": "user", "content": "And now?"},
]
_TOOLS = [{"name": "get_weather", "description": "weather by city",
           "parameters": {"type": "object", "properties": {"city": {"type": "string"}}}}]


@pytest.mark.parametrize("name", ["qwen2_vl", "llama3", "llama2", "gemma", "chatml",
                                  "mistral", "glm4", "default"])
def test_template_copy_renders_as_the_jax_package(name):
    """The port keeps its own copy of the jax-free template module: the
    same prompts, encodings and tool-call parsing."""
    import infinitevl_tpu.data.template as jt
    import infinitevl_tpu_torch.data.template as tt
    from infinitevl_tpu.data.loader import SimpleTokenizer as JTok
    from infinitevl_tpu_torch.data.loader import SimpleTokenizer as TTok

    assert tt.__file__ != jt.__file__
    j, t = jt.get_template(name), tt.get_template(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for kw in (dict(add_generation_prompt=True), dict(add_generation_prompt=False),
               dict(add_generation_prompt=True, tools=_TOOLS)):
        assert t.render_prompt(_MESSAGES, **kw) == j.render_prompt(_MESSAGES, **kw)
    got = t.encode_turns(TTok(), _MESSAGES)
    want = j.encode_turns(JTok(), _MESSAGES)
    assert [list(map(int, x)) for x in got] == [list(map(int, x)) for x in want]
    text = 'so <tool_call>\n{"name": "f", "arguments": {"a": 1}}\n</tool_call>'
    assert tt.extract_tool_calls(text) == jt.extract_tool_calls(text) == \
        [{"name": "f", "arguments": {"a": 1}}]
    assert tt.extract_tool_calls("plain") == "plain"
    assert sorted(n for n in dir(tt) if not n.startswith("_")) == \
        sorted(n for n in dir(jt) if not n.startswith("_"))


@pytest.mark.parametrize("text", ["hello world hello", "a<|image_pad|><|image_pad|>b\nc",
                                  "<image>what <|vision_start|> now", ""])
def test_simple_tokenizer_copy_matches(text):
    from infinitevl_tpu.config import tiny_config
    from infinitevl_tpu.data.loader import SimpleTokenizer as JTok
    from infinitevl_tpu_torch.data.loader import SimpleTokenizer as TTok

    cfg = tiny_config()
    for kw in ({}, dict(config=cfg), dict(vocab={"hello": 7}, unk=3)):
        j, t = JTok(**kw), TTok(**kw)
        ids = t.encode(text)
        assert ids == j.encode(text) and t.vocab == j.vocab
        assert t.decode(ids + [999]) == j.decode(ids + [999])
        assert (t.eos_token_id, t.unk) == (j.eos_token_id, j.unk)


def test_chip_smoke_refuses_without_cuda():
    # no card visible to the child, whatever this machine has
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env={**ENV, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ""},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
