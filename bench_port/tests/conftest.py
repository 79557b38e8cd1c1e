"""Tests of the port's benchmark harness. The CPU tests run anywhere; tests
marked `card` need a CUDA card and skip without one (decided inside the
test, never at import).

    python -m pytest bench_port/tests -q -p no:cacheprovider

On a machine with a CUDA card the same command runs the `card` tests too:
the controls at the cells' own sizes."""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size there")
    return torch.device("cuda", 0)


TINY_STREAM = {"driver": "stream", "cameras": 4, "frame_hw": [112, 112], "fps": 30.0,
               "pool_frames": 3, "prime_frames": 3, "prep_workers": 2, "check_streams": 2,
               "check_step": [2, 3], "probe_vocab": 500, "traced_steps": 2}
TINY_DOCQA = {"driver": "docqa", "doc_lengths": [2100, 300, 600], "question_tokens": 4,
              "answer_tokens": 24, "id_high": 500, "check_requests": 3}
TINY_LIMITS = {"stream": {"state_err": 1e-4, "probe_logit_err": 1e-4},
               "docqa": {"answer_gap_mean": 1e-4}}


def tiny_spec(mixer: str = "linear_attention"):
    """The port's tiny test configuration as a configuration file, fp32."""
    from infinitevl_tpu_torch.config import tiny_config

    d = dataclasses.asdict(tiny_config())
    d["text"]["layer_types"] = [mixer if t == "linear_attention" else t
                                for t in d["text"]["layer_types"]]
    ids = {k: d[k] for k in d if k.endswith("_token_id")}
    return {"name": f"tiny_{mixer}", "source": "tests", "reduced": [], "dtype": "float32",
            "reference": "infinitevl", "text": d["text"], "vision": d["vision"], **ids}


def assemble(root: Path) -> dict:
    """A benchmark folder of test-only cells at `root`: the harness's code
    copied, configurations, traffic mixes, limits and BENCHMARK.json of its
    own. Returns the parsed BENCHMARK.json."""
    for sub in ("drivers", "metrics", "work"):
        shutil.copytree(BENCH / sub, root / sub, ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir()
    cells = []
    for mixer, short in (("linear_attention", "delta"), ("mamba2", "m2")):
        (root / "configs" / f"tiny_{short}.json").write_text(json.dumps(tiny_spec(mixer)))
        cells.append({"name": f"stream_tiny.{short}", "config": f"tiny_{short}",
                      "traffic": "stream_tiny", "chips": 1, "why": "test"})
    cells.append({"name": "docqa_tiny.delta", "config": "tiny_delta", "traffic": "docqa_tiny",
                  "chips": 1, "why": "test"})
    (root / "traffic" / "stream_tiny.json").write_text(json.dumps(TINY_STREAM))
    (root / "traffic" / "docqa_tiny.json").write_text(json.dumps(TINY_DOCQA))
    for c in cells:
        kind = "docqa" if c["traffic"] == "docqa_tiny" else "stream"
        (root / "limits" / f"{c['name']}.json").write_text(json.dumps(TINY_LIMITS[kind]))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    streams = [c["name"] for c in cells if c["traffic"] == "stream_tiny"]
    docs = [c["name"] for c in cells if c["traffic"] == "docqa_tiny"]
    remap = {}
    for w in real["workloads"]:
        remap[w["name"]] = streams if w["traffic"].startswith("stream") else docs
    bench = dict(real, workloads=cells)
    for group in ("end_to_end", "per_layer"):
        ms = []
        for m in real[group]:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = sorted({x for w in m["workloads"] for x in remap[w]})
            ms.append(m)
        bench[group] = ms
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    return root, assemble(root)


def run_tiny(root, bench, workload, seed=7, seconds=0.5, trace=False):
    """One run of a test-only cell on the CPU through run.py's execute()."""
    import time

    import torch
    import run as bench_run
    from harness.spec import resolve

    cell = resolve(bench, workload, root)
    return bench_run.execute(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
