"""The training slice as a whole against the JAX package on the CPU in
fp32: the port's dataset pipeline and collators (batches equal the JAX
collators' arrays exactly), `run_sft` on the two tiny recipes end to end,
resume (bit-equal continuation), a full finetune read back from its HF
export bit-equal, `cli board`, and the options and commands of later
slices, which raise by name. The recipes' parsing and the `Trainer` loss
curves are in test_torch_port_trainer_curves.py."""

import glob
import json
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu.train.trainer as jtrainer
import infinitevl_tpu_torch.hparams as thparams
import infinitevl_tpu_torch.train.trainer as ttrainer
from infinitevl_tpu_torch.train.step import tree_leaves_with_path
from infinitevl_tpu_torch.utils.checkpoint import latest_step, restore_train_state

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(REPO, "examples", "*.yaml")))


def _args(mod, name, tmp_path=None, **over):
    args = mod.load_yaml_args(os.path.join(REPO, "examples", name))
    args.data.dataset_dir = os.path.join(REPO, "data")
    if tmp_path is not None:
        args.train.output_dir = str(tmp_path)
    for key, val in over.items():
        group = next(g for g in (args.model, args.data, args.train, args.finetune, args.gen)
                     if hasattr(g, key))
        setattr(group, key, val)
    return args


def _same_batches(jbatches, tbatches, n):
    seen = 0
    for jitem, titem in zip(jbatches, tbatches):
        jb, jrest = (jitem[0], jitem[1:]) if isinstance(jitem, tuple) else (jitem, ())
        tb, trest = (titem[0], titem[1:]) if isinstance(titem, tuple) else (titem, ())
        assert jrest == trest
        assert set(jb) == set(tb)
        for k in jb:
            a, b = np.asarray(jb[k]), np.asarray(tb[k])
            # jnp.asarray narrows the collator's 64-bit integers to 32 bits
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        seen += 1
    assert seen == n


def test_text_dataset_and_collate_equal_jax():
    ja, ta = _args(jhparams, "sft_tiny.yaml"), _args(thparams, "sft_tiny.yaml")
    jd, td = jtrainer.build_dataset(ja), ttrainer.build_dataset(ta)
    assert len(jd) == len(td) and not ttrainer.is_multimodal(td)
    for a, b in zip(jd, td):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    _same_batches(jtrainer.collate(jd, 2, 64, seed=3, epochs=2.0),
                  ttrainer.collate(td, 2, 64, seed=3, epochs=2.0), len(td))
    # unpacked rows too
    ja.data.packing = ta.data.packing = False
    jd, td = jtrainer.build_dataset(ja), ttrainer.build_dataset(ta)
    _same_batches(jtrainer.collate(jd, 3, 48, seed=1), ttrainer.collate(td, 3, 48, seed=1),
                  int(np.ceil(len(td) / 3)))


def test_multimodal_dataset_and_collate_equal_jax():
    ja, ta = _args(jhparams, "mm_sft_tiny.yaml"), _args(thparams, "mm_sft_tiny.yaml")
    jcfg = jtrainer.build_config(ja)
    tcfg = ttrainer.build_config(ta)
    assert tcfg == to_port_config(jcfg)
    jd, td = jtrainer.build_dataset(ja, cfg=jcfg), ttrainer.build_dataset(ta, cfg=tcfg)
    assert len(jd) == len(td) and ttrainer.is_multimodal(td)
    _same_batches(jtrainer.collate_mm(jd, jcfg, 1, 256, seed=0, epochs=1.0),
                  ttrainer.collate_mm(td, tcfg, 1, 256, seed=0, epochs=1.0), len(td))


@pytest.mark.parametrize("name,over", [
    ("sft_tiny.yaml", dict(do_predict=True, predict_samples=2, max_new_tokens=4,
                           val_size=0.25)),
    ("sft_tiny.yaml", dict(finetuning_type="lora", learning_rate=1e-2, remat=True)),
    ("sft_tiny.yaml", dict(finetuning_type="lora", quantization_bit=8, use_rslora=True,
                           gradient_accumulation_steps=2)),
    ("sft_tiny.yaml", dict(finetuning_type="freeze", freeze_trainable_layers=2)),
    ("mm_sft_tiny.yaml", dict()),
    ("mm_sft_tiny.yaml", dict(finetuning_type="lora", remat=True, remat_group=2)),
], ids=["full+predict+val", "lora+remat", "qlora+rslora+accum", "freeze", "mm", "mm-lora"])
def test_run_sft_end_to_end(tmp_path, name, over):
    """run_sft on the tiny recipes as they are (plus one finetuning type
    each): the loss falls, the log and a checkpoint are written, and
    do_predict writes its scores."""
    args = _args(thparams, name, tmp_path, logging_steps=1, num_train_epochs=8.0, **over)
    final = ttrainer.run_sft(args, device="cpu")
    recs = [json.loads(l) for l in open(os.path.join(str(tmp_path), "trainer_log.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    steps = args.train.max_steps
    assert len(losses) == steps and all(np.isfinite(losses))
    if name == "sft_tiny.yaml":  # text: 8 steps over 4 packed rows repeat the data
        assert min(losses[-2:]) < losses[0]
    ckpt = os.path.join(str(tmp_path), "checkpoints")
    assert latest_step(ckpt) == steps
    _, state = restore_train_state(ckpt)
    expect = steps // args.train.gradient_accumulation_steps
    assert state["opt_state"]["count"] == expect
    assert all(torch.isfinite(t).all() for _, t in tree_leaves_with_path(final)
               if t.is_floating_point())
    if over.get("finetuning_type") == "lora":
        # the merged export carries kernels, never side paths or int8 targets
        q = final["text"]["layers"][0]["q_proj"]
        assert "kernel" in q and "lora_a" not in q and "kernel_q" not in q
    if over.get("do_predict"):
        scores = json.load(open(os.path.join(str(tmp_path), "predict_results.json")))
        assert scores["samples"] == 2 and "bleu-4" in scores
        assert any("eval_loss" in r for r in recs)
        assert os.path.exists(os.path.join(str(tmp_path), "generated_predictions.jsonl"))


@pytest.mark.parametrize("ft", ["full", "lora"])
def test_resume_continues_bit_equal(tmp_path, ft):
    """Four steps straight against two steps, a save, a fresh process
    state, a resume and two more: parameters (or adapters) and the
    optimizer state are bit-equal."""
    def run(out, max_steps, resume):
        args = _args(thparams, "sft_tiny.yaml", out, finetuning_type=ft, max_steps=max_steps,
                     lr_scheduler_type="constant", num_train_epochs=8.0, save_steps=2,
                     resume_from_checkpoint="auto" if resume else None)
        ttrainer.run_sft(args, device="cpu")
        return restore_train_state(os.path.join(str(out), "checkpoints"))

    step_a, a = run(tmp_path / "straight", 4, False)
    run(tmp_path / "resumed", 2, False)
    step_b, b = run(tmp_path / "resumed", 4, True)
    assert step_a == step_b == 4
    la, lb = (dict(tree_leaves_with_path(s)) for s in (a, b))
    assert set(la) == set(lb) and len(la) > 4
    assert all(torch.equal(la[p], lb[p]) for p in la)
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 4


LATER = [
    # ported since (ops/mamba2.py): the case now holds that the mixer runs
    ("dt_stage1_mamba2_tiny.yaml", dict(max_steps=1), None),
    # ported since (parallel/pipeline.py): the recipe's pipe 2 x data 2 x model 2 needs a
    # world of eight ranks (tests/test_torch_port_pipeline_ranks.py); one process refuses
    # it by name
    ("sft_pp_tiny.yaml", {}, (ValueError, "need 8 ranks")),
    # ported since (parallel/sharding.py): data_parallel 2 needs a world of two
    # ranks (tests/test_torch_port_parallel.py); one process refuses it by name
    ("sft_tiny.yaml", dict(data_parallel=2), (ValueError, "data_parallel")),
    # ported since (streaming datasets): the case now holds that the option runs
    ("sft_tiny.yaml", dict(streaming=True, max_steps=1), None),
    # ported since (train/optim.py): the case now holds that the option runs
    ("sft_tiny.yaml", dict(use_optimizer="galore", max_steps=1), None),
    # ported since (train/lora.py, DoRA)
    ("sft_tiny.yaml", dict(finetuning_type="lora", use_dora=True, max_steps=1), None),
]


@pytest.mark.parametrize("name,over,match", LATER, ids=[
    "mixer_mamba2", "pipeline", "data_parallel", "streaming", "use_optimizer", "use_dora"])
def test_stages_and_options_of_later_slices_raise(tmp_path, name, over, match):
    """Each raises by name; a case whose option a slice has ported since
    (match None) runs one step with a finite loss instead, and one whose
    option now needs more than the test gives it ((error, match)) raises
    that error by name."""
    args = _args(thparams, name, tmp_path, **over)
    if match is None:
        ttrainer.run_exp(args, device="cpu")
        recs = [json.loads(l) for l in open(os.path.join(str(tmp_path), "trainer_log.jsonl"))]
        assert [np.isfinite(r["loss"]) for r in recs if "loss" in r] == [True]
        return
    error, match = match if isinstance(match, tuple) else (NotImplementedError, match)
    with pytest.raises(error, match=match):
        ttrainer.run_exp(args, device="cpu")


def test_full_finetune_survives_the_hf_export(tmp_path):
    """A full finetune exported as HF safetensors and read back is the
    model that was trained: every leaf bit-equal and the same greedy
    tokens. The export does not store rope's inv_freq (the loader rebuilds
    it from the config), so full finetuning must leave it as it is."""
    from infinitevl_tpu_torch.generation import Generator
    from infinitevl_tpu_torch.models.params import load_hf_checkpoint
    from infinitevl_tpu_torch.utils.checkpoint import export_hf_safetensors

    args = _args(thparams, "sft_tiny.yaml", tmp_path / "run", max_steps=3, learning_rate=1e-2,
                 lr_scheduler_type="constant")
    cfg = ttrainer.build_config(args)
    trained = ttrainer.run_sft(args, device="cpu")
    export_hf_safetensors(trained, cfg, str(tmp_path / "hf"))
    loaded = load_hf_checkpoint(str(tmp_path / "hf"), cfg, torch.float32, device="cpu")
    a = dict(tree_leaves_with_path(trained["text"]))
    b = dict(tree_leaves_with_path(loaded["text"]))
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    prompt = np.arange(3, 23)[None] % 400
    tokens = [Generator({"text": t}, cfg, dtype=torch.float32, device="cpu").generate(
        prompt, max_new_tokens=8, temperature=0.0) for t in (trained["text"], loaded["text"])]
    np.testing.assert_array_equal(tokens[0], tokens[1])


@pytest.mark.parametrize("argv,env,match", [
    (["bench"], {}, "no benchmark"),
    # ported since (parallel/): `train` joins the launcher's world, and a world
    # above one without its address raises by name instead of training alone
    (["train", "sft_tiny.yaml"], {"WORLD_SIZE": "2"}, (ValueError, "MASTER_ADDR")),
    (["train", "sft_tiny.yaml"], {"NUM_PROCESSES": "4"}, (ValueError, "COORDINATOR_ADDRESS")),
], ids=["bench", "world_size", "num_processes"])
def test_cli_commands_of_later_slices_raise(monkeypatch, argv, env, match):
    from infinitevl_tpu_torch.cli import main

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    argv = argv[:1] + [os.path.join(REPO, "examples", a) for a in argv[1:]]
    error, match = match if isinstance(match, tuple) else (NotImplementedError, match)
    with pytest.raises(error, match=match):
        main(argv)


def test_cli_board_serves_the_ports_board(monkeypatch, tmp_path):
    """`cli board 0 --device cpu` starts the port's board server (on a free
    port), which answers /api/status; without a card and without --device
    the command raises instead of running on the CPU."""
    import threading
    import urllib.request

    from infinitevl_tpu_torch.cli import main
    from infinitevl_tpu_torch.serve import webui

    made = []

    def create(host, port, runs_root, device):  # on loopback, runs under tmp_path
        made.append(webui_create("127.0.0.1", port, str(tmp_path), device))
        return made[-1]

    webui_create = webui.create_board_server
    monkeypatch.setattr(webui, "create_board_server", create)
    rc = []
    t = threading.Thread(target=lambda: rc.append(main(["board", "0", "--device", "cpu"])),
                         daemon=True)
    t.start()
    for _ in range(200):
        if made:
            break
        t.join(0.05)
    server = made[0]
    assert server.runner.device == torch.device("cpu")
    url = f"http://127.0.0.1:{server.server_address[1]}/api/status"
    with urllib.request.urlopen(url, timeout=30) as r:
        assert json.loads(r.read()) == {"running": False}
    server.shutdown()
    t.join(30)
    assert not t.is_alive() and rc == [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["board", "0"])


def test_memory_knobs_are_accepted_and_int4_training_refused(tmp_path):
    """scan_layers / remat_mode / scan_unroll / remat_barrier choose a
    memory layout in the JAX package and change no number: accepted."""
    args = _args(thparams, "sft_tiny.yaml", tmp_path, max_steps=1, remat=True,
                 scan_layers=True, remat_mode="nested", scan_unroll=3, remat_barrier=True)
    base = _args(thparams, "sft_tiny.yaml", tmp_path / "base", max_steps=1, remat=True)
    a, b = ttrainer.run_sft(args, device="cpu"), ttrainer.run_sft(base, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves_with_path(a),
                                                           tree_leaves_with_path(b)))
    for over, match in ((dict(quantization_bit=4, finetuning_type="lora"), "quantization_bit: 8"),
                        (dict(quantization_bit=8), "finetuning_type: lora"),
                        (dict(finetuning_type="adapter"), "unknown finetuning_type")):
        with pytest.raises(ValueError, match=match):
            ttrainer.run_sft(_args(thparams, "sft_tiny.yaml", tmp_path, **over), device="cpu")


def test_long_context_recipe_builds_its_config():
    """sft_32k_lora_yarn.yaml: parsed, and its yarn rope scaling lands in
    the port's config as in the JAX package's."""
    ja = _args(jhparams, "sft_32k_lora_yarn.yaml")
    ta = _args(thparams, "sft_32k_lora_yarn.yaml")
    assert ttrainer.build_config(ta) == to_port_config(jtrainer.build_config(ja))
    assert ta.finetune.finetuning_type == "lora" and ta.train.remat
