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
               "ops.delta_kernels"):
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


def test_port_never_loads_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_PROGRAM], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_importing_the_port_loads_nothing_of_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", NOTHING_OF_JAX_PROGRAM], cwd=REPO,
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FOREIGN_MODULES []" in proc.stdout, proc.stdout


def test_no_jax_import_lines_in_the_port():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import infinitevl_tpu\b|from infinitevl_tpu[. ])", re.M)
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
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
