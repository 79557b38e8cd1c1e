"""The torch twins of the repo scripts (scripts/torch_*.py) against the JAX
scripts on the same inputs, on the CPU: cal_flops' and cal_mfu's numbers
equal, eval_bleu_rouge's and length_cdf's outputs equal, cal_ppl within
1e-4, llama_pro's expanded tensors equal, batch_infer's greedy predictions
identical; prefill_bench and cal_mfu --measure need the card and raise by
name without one."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")

torch.set_num_threads(2)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_out(capsys, monkeypatch, name, *argv):
    """stdout of the JAX script `name` run as from the command line."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    main = _script(name).main
    if name == "llama_pro":
        main(argv[0], argv[1], int(argv[2]))
    elif name in ("cal_ppl", "length_cdf", "eval_bleu_rouge"):
        main(*argv)
    else:
        main()
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def jax_tiny_ckpt(tmp_path_factory):
    """The JAX tiny model (PRNGKey(0), bf16 as the JAX scripts load it) as an
    HF checkpoint, read by both packages."""
    from infinitevl_tpu.config import tiny_config
    from infinitevl_tpu.models.params import init_params
    from infinitevl_tpu.utils.checkpoint import export_hf_safetensors

    out = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    export_hf_safetensors(init_params(jax.random.PRNGKey(0), tiny_config()), tiny_config(), out)
    return out


@pytest.mark.parametrize("argv", [[], ["--batch_size", "4", "--seq_length", "8192",
                                       "--include_backward"]], ids=["3b", "pass_8k_fwd_bwd"])
def test_cal_flops_prints_the_jax_numbers(argv, capsys, monkeypatch):
    want = _jax_out(capsys, monkeypatch, "cal_flops", *argv)
    kw = {"batch_size": 4, "seq_length": 8192, "include_backward": True} if argv else {}
    got = _script("torch_cal_flops").main(**kw)
    assert capsys.readouterr().out == want
    assert f"params: {got['params'] / 1e9:.3f} B" in want


def test_cal_mfu_from_tokens_per_sec_equals_jax_at_the_same_peak(capsys, monkeypatch):
    want = _jax_out(capsys, monkeypatch, "cal_mfu", "--tokens_per_sec", "4294",
                    "--peak_tflops", "989")
    got = _script("torch_cal_mfu").main(tokens_per_sec=4294.0)  # the H100's 989 by default
    assert capsys.readouterr().out == want
    assert got["mfu"] == 3.0 * 4294.0 * got["flops_per_token"] / 989e12


def test_eval_bleu_rouge_equals_jax(tmp_path, capsys, monkeypatch):
    path = tmp_path / "preds.jsonl"
    rows = [{"predict": "the cat sat on the mat", "label": "the cat is on the mat"},
            {"predict": "hello world", "label": "hello there world"},
            {"predict": "", "label": "nothing"}]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    want = _jax_out(capsys, monkeypatch, "eval_bleu_rouge", str(path))
    got = _script("torch_eval_bleu_rouge").main(str(path))
    assert capsys.readouterr().out == want
    assert got["samples"] == 3


@pytest.mark.parametrize("yaml_name", ["sft_tiny.yaml", "mm_sft_tiny.yaml"])
def test_length_cdf_equals_jax(yaml_name, tmp_path, capsys, monkeypatch):
    src = open(os.path.join(REPO, "examples", yaml_name)).read()
    cfg = tmp_path / yaml_name
    cfg.write_text(src + f"\ndataset_dir: {DATA}\n")
    want = _jax_out(capsys, monkeypatch, "length_cdf", str(cfg))
    got = _script("torch_length_cdf").main(str(cfg))
    assert capsys.readouterr().out == want
    assert got["n"] > 0


def test_cal_ppl_within_1e_4_of_jax(jax_tiny_ckpt, tmp_path, capsys, monkeypatch):
    cfg = tmp_path / "ppl.yaml"
    cfg.write_text(f"config_preset: tiny\nmodel_name_or_path: {jax_tiny_ckpt}\n"
                   f"dataset: demo\ndataset_dir: {DATA}\ncutoff_len: 128\n"
                   "per_device_train_batch_size: 2\nbf16: false\n")
    want = _jax_out(capsys, monkeypatch, "cal_ppl", str(cfg)).split()
    got = _script("torch_cal_ppl").main(str(cfg), device="cpu")
    assert int(want[1]) == got["tokens"] > 0
    assert abs(got["nll"] - float(want[3])) <= 1e-4
    assert abs(got["ppl"] / float(want[5]) - 1.0) <= 1e-3  # the JAX line's 3 decimals


def test_llama_pro_expanded_checkpoint_equals_jax(jax_tiny_ckpt, tmp_path, capsys,
                                                  monkeypatch):
    from infinitevl_tpu_torch.models.params import checkpoint_files
    from infinitevl_tpu_torch.utils.safetensors_io import iter_file

    def load(path):
        return {k: t for fp in checkpoint_files(path) for k, t in iter_file(fp, "cpu")}

    jdst, tdst = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _jax_out(capsys, monkeypatch, "llama_pro", jax_tiny_ckpt, jdst, "2")
    _script("torch_llama_pro").main(jax_tiny_ckpt, tdst, 2, device="cpu")
    assert capsys.readouterr().out == want.replace(jdst, tdst)
    a, b = load(jdst), load(tdst)
    assert sorted(a) == sorted(b) and len(a) > 0
    assert [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])] == []
    assert json.load(open(os.path.join(jdst, "config.json"))) == \
        json.load(open(os.path.join(tdst, "config.json")))


def test_batch_infer_greedy_predictions_equal_jax(jax_tiny_ckpt, tmp_path, capsys,
                                                  monkeypatch):
    """JAX's run without a checkpoint (its tiny PRNGKey(0) model and
    SimpleTokenizer), the port's from that model's export (no tokenizer
    files: SimpleTokenizer too)."""
    common = ["--dataset", "demo", "--dataset_dir", DATA, "--max_new_tokens", "8",
              "--max_samples", "4"]
    jout, tout = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    _jax_out(capsys, monkeypatch, "batch_infer", *common, "--save_name", jout)
    rows = _script("torch_batch_infer").main(
        [*common, "--save_name", tout, "--checkpoint", jax_tiny_ckpt, "--device", "cpu"])
    want = [json.loads(line) for line in open(jout)]
    assert [json.loads(line) for line in open(tout)] == rows == want
    assert len(rows) == 4 and any(r["predict"] for r in rows)


@pytest.mark.parametrize("call", ["prefill_bench", "prefill_bench_train", "cal_mfu_measure"])
def test_card_measurements_raise_by_name_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if call.startswith("prefill_bench"):
        fn, match = lambda: _script("torch_prefill_bench").main(
            seqlen=64, layers=2, train=call.endswith("train")), "prefill_bench"
    else:
        fn, match = lambda: _script("torch_cal_mfu").main(measure=True, seq_length=64,
                                                          layers=2), "cal_mfu --measure"
    with pytest.raises(RuntimeError, match=match):
        fn()
    assert np.isfinite(_script("torch_cal_mfu").main(tokens_per_sec=1.0)["mfu"])
