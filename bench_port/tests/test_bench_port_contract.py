"""BENCHMARK.json against its schema: keys, names, units and
lengths; every cell's files found by name; a cell assembled from test-only
files resolves and runs; no run loads jax or the JAX package."""

import ast
import json
import re
import subprocess
import sys
import textwrap

import pytest
from conftest import BENCH, ROOT, run_tiny

from harness.spec import read_json, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _one_line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_units_and_lengths(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("bench_port/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cfgs = set(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in cfgs
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        names.append(w["name"])
    cells = {w["name"] for w in bench["workloads"]}
    assert {w["config"] for w in bench["workloads"]} == cfgs  # every configuration used
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells and ("workloads" not in moved or w in moved["workloads"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for w in cells:  # every cell: setup_s, one more end-to-end metric, one per-layer metric
        cell = resolve(bench, w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_every_cells_files_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell = resolve(bench, w["name"])
        assert cell.driver().run and set(cell.limits)
        for m in cell.per_layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in bench["configs"]:
        spec = read_json(ROOT / c["file"])
        assert spec["name"] == c["name"] and spec["reduced"] == c["reduced"]
    for f in (BENCH / "work").glob("*.py"):
        src = f.read_text()
        assert "TRACE_NAMES" in src and "def work(" in src


def test_a_cell_of_test_only_files_resolves_and_runs(tiny_bench):
    """A configuration, a traffic mix, a metric and a kernel's work count added
    as new files plus entries, nothing else edited."""
    root, bench = tiny_bench
    (root / "metrics" / "answer_tokens.docqa.py").write_text(textwrap.dedent('''
        def read(ctx):
            return ctx.window["prefill_flops"] and 1.0
    '''))
    (root / "work" / "head.py").write_text(textwrap.dedent('''
        TRACE_NAMES = ("gemm",)
        def work(M, N, K):
            return 2.0 * M * N * K, 2.0 * (M * K + K * N + M * N), 989e12
    '''))
    bench = json.loads(json.dumps(bench))
    bench["per_layer"].append({"name": "answer_tokens.docqa", "unit": "tokens", "better": "higher",
                               "source": "host_clock", "layer": "generation.Generator",
                               "moves": "ttft_p50_ms", "workloads": ["docqa_tiny.delta"]})
    cell = resolve(bench, "docqa_tiny.delta", root)
    assert "answer_tokens.docqa" in {m["name"] for m in cell.per_layer}
    from harness.spec import work_module

    assert work_module(root, "head").work(1, 2, 3)[0] == 12.0
    out, lines = run_tiny(root, bench, "docqa_tiny.delta", trace=True)
    assert out["correct"] and out["metrics"]["answer_tokens.docqa"]["value"] == 1.0
    assert list(out)[-1] == "checks" and lines[-1].startswith("check answer_gap_mean")


PROBE = textwrap.dedent('''
    import json, sys
    sys.path[:0] = [{bench!r}, {root!r}]
    sys.path.insert(0, {tests!r})
    from pathlib import Path
    from conftest import assemble, run_tiny
    import run
    root = Path({tmp!r})
    bench = assemble(root)
    for w in [c["name"] for c in bench["workloads"]]:
        out, _ = run_tiny(root, bench, w)
        assert out["correct"], (w, out)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    print(json.dumps(run.forbidden_modules()))
''')


def test_no_traffic_driver_loads_jax_or_the_jax_package(tmp_path):
    code = PROBE.format(bench=str(BENCH), root=str(ROOT), tests=str(BENCH / "tests"),
                        tmp=str(tmp_path / "b"))
    (tmp_path / "b").mkdir()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    top, bad = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert "infinitevl_tpu_torch" in top and "torch" in top
    assert bad == [] and not {"jax", "jaxlib", "flax", "infinitevl_tpu"} & set(top)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                for m in mods:
                    assert m.split(".")[0] not in ("jax", "jaxlib", "flax", "infinitevl_tpu",
                                                   "infinitevl_tpu_torch", "harness"), (f, m)


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "stream448_cam16.ivl3b", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_folder_of_only_the_benchmark(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns(".cache"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "stream448_cam16.ivl3b", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
