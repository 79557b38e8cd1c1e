"""The MCQ evaluator and the command line of the port against the JAX
package on the CPU in fp32:

- `MCQEvaluator`: the choice logits of left-padded length buckets within
  1e-4 (err_ratio) of JAX's `_mcq_prefill` and of each prompt scored alone
  without pads, equal predictions, equal `evaluate_task` metrics;
- `cli`: the return codes of help / version / an unknown command, `export`
  then `eval` through `model_name_or_path` (the JAX package reads the
  port's export and reaches the same metrics), `chat` with `input`
  patched (the tokens of `Generator.generate`), `api` with `run_api`
  patched, `train` on the SFT, distillation, rm, dpo and kto recipes (ppo:
  tests/test_torch_port_ppo.py);
- `resolve_tokenizer` on a tiny BPE built here: the ids of JAX's."""

import builtins
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch_port_helpers import err_ratio, to_port_config
from torch_port_helpers import jax_compile_cache  # noqa: F401 (autouse)

import infinitevl_tpu.cli as jcli
import infinitevl_tpu.eval.mcq as jmcq
import infinitevl_tpu.hparams as jhparams
import infinitevl_tpu_torch.cli as tcli
import infinitevl_tpu_torch.eval.mcq as tmcq
import infinitevl_tpu_torch.hparams as thparams
from infinitevl_tpu.config import tiny_config
from infinitevl_tpu.data.loader import SimpleTokenizer as JTok
from infinitevl_tpu.data.loader import resolve_tokenizer as jresolve
from infinitevl_tpu.generation import Generator as JGenerator
from infinitevl_tpu.models.params import init_params
from infinitevl_tpu_torch.data.loader import SimpleTokenizer as TTok
from infinitevl_tpu_torch.data.loader import resolve_tokenizer as tresolve
from infinitevl_tpu_torch.data.template import get_template
from infinitevl_tpu_torch.generation import Generator
from infinitevl_tpu_torch.models.params import from_jax_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_config()
TCFG = to_port_config(CFG)


@pytest.fixture(scope="module")
def generators():
    jp = init_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    return (JGenerator(jp, CFG, dtype=jnp.float32),
            Generator(from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu"), TCFG,
                      dtype=torch.float32, device="cpu"))


def _task():
    with open(os.path.join(REPO, "data", "mcq_demo.json")) as f:
        return json.load(f)


def test_mcq_evaluator_matches_jax(generators):
    """Prompts of two length buckets (128 and 256 positions), 0-, 3- and
    9-shot, in batches of 4 (a short batch repeats its rows)."""
    jg, tg = generators
    jev, tev = jmcq.MCQEvaluator(jg, JTok(), batch_size=4), tmcq.MCQEvaluator(tg, TTok(),
                                                                             batch_size=4)
    assert tev.choice_ids == jev.choice_ids
    task = _task()
    block = task["elementary_arithmetic"]
    supports = ([], block["dev"], block["dev"] * 3)  # 0, 3 and 9 shots
    prompts = [tmcq.format_example(ex, sup, block["name"])
               for sup in supports for ex in block["test"][:2]]
    assert prompts == [jmcq.format_example(ex, sup, block["name"])
                       for sup in supports for ex in block["test"][:2]]
    got = tev.choice_logits(prompts)
    lengths = [len(tev.tokenizer.encode(p)) for p in prompts]
    assert {tmcq._bucket_len(n) for n in lengths} == {128, 256}
    # JAX's _mcq_prefill on the same left-padded rows, bucket by bucket
    want = np.zeros_like(got)
    alone = np.zeros_like(got)
    for i, p in enumerate(prompts):
        ids = np.asarray(tev.tokenizer.encode(p), np.int64)
        P = tmcq._bucket_len(len(ids))
        a, pos, seg = tmcq.left_padded_batch([ids] * 4, P)
        logits = jmcq._mcq_prefill(jg.params, CFG, jnp.asarray(a), jnp.asarray(pos),
                                   jnp.asarray(seg))
        want[i] = np.asarray(logits)[0, tev.choice_ids]
        # the prompt alone, no pads, no segment ids
        _, pos1, _ = tmcq.left_padded_batch([ids], len(ids))
        one = tmcq.last_logits(tg.params, TCFG, ids[None], pos1, np.ones((1, len(ids)),
                                                                         np.int32), "cpu")
        alone[i] = one[0, tev.choice_ids].numpy()
    assert err_ratio(got, want) < 1e-4 and err_ratio(got, alone) < 1e-4
    assert (got.argmax(1) == want.argmax(1)).all() and (got.argmax(1) == alone.argmax(1)).all()
    assert tev._score_prompts(prompts) == jev._score_prompts(prompts)
    small = {k: {"name": v["name"], "dev": v["dev"][:2], "test": v["test"][:3]}
             for k, v in task.items()}
    assert tev.evaluate_task(small, n_shot=2) == jev.evaluate_task(small, n_shot=2)


def test_cli_return_codes(capsys, monkeypatch):
    assert tcli.main([]) == 0 and "train" in capsys.readouterr().out
    assert tcli.main(["help"]) == 0 and "export" in capsys.readouterr().out
    assert tcli.main(["version"]) == 0
    from infinitevl_tpu_torch import __version__

    assert capsys.readouterr().out.strip() == __version__
    assert tcli.main(["bogus"]) == 2 and "unknown command" in capsys.readouterr().out
    assert tcli.main(["eval"]) == 2 and "requires a config.yaml" in capsys.readouterr().out
    assert jcli.main(["bogus"]) == tcli.main(["bogus"])


def _yaml(tmp_path, name, **conf):
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


def test_export_then_eval_through_model_name_or_path(tmp_path, capsys):
    """`export` writes the seed-0 tiny model as HF safetensors + Modelfile;
    `eval` on data/mcq_demo.json (3-shot, batches of 4) loads it through
    model_name_or_path, as does the JAX package's `eval`: equal metrics."""
    out = str(tmp_path / "export")
    tcli.cmd_export(_yaml(tmp_path, "export", config_preset="tiny", bf16=False, output_dir=out),
                    device="cpu")
    assert {"model.safetensors", "config.json", "Modelfile"} <= set(os.listdir(out))
    conf = yaml.safe_load(open(os.path.join(REPO, "examples", "eval_mcq.yaml")))
    conf.update(model_name_or_path=out, dataset_dir=os.path.join(REPO, "data"), bf16=False,
                eval_save_dir=str(tmp_path / "eval_port"))
    got = tcli.cmd_eval(_yaml(tmp_path, "eval", **conf), device="cpu")
    conf["eval_save_dir"] = str(tmp_path / "eval_jax")
    jcli.cmd_eval(_yaml(tmp_path, "eval_jax", **conf))
    want = json.load(open(tmp_path / "eval_jax" / "results.json"))
    assert got == want == json.load(open(tmp_path / "eval_port" / "results.json"))
    assert set(got) == {"accuracy", "accuracy/elementary_arithmetic", "accuracy/world_capitals"}


def test_chat_gives_the_tokens_of_generate(tmp_path, capsys, monkeypatch):
    path = _yaml(tmp_path, "chat", config_preset="tiny", bf16=False, do_sample=False,
                 max_new_tokens=6)
    lines = iter(["hello there", "exit"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(lines))
    tcli.cmd_chat(path, device="cpu")
    said = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Assistant: ")]
    args = thparams.load_yaml_args(path)
    gen, cfg = tcli._build_generator(args, "cpu")
    tok = TTok(config=cfg)
    prompt = get_template(args.data.template).render_prompt(
        [{"role": "user", "content": "hello there"}])
    out = gen.generate(np.asarray([tok.encode(prompt)]), max_new_tokens=6, temperature=0.0)
    assert said == [f"Assistant: {tok.decode(out[0], skip_special_tokens=True)}"]


def test_api_builds_its_backend(tmp_path, monkeypatch):
    import infinitevl_tpu_torch.serve.api as tapi

    seen = {}
    monkeypatch.setattr(tapi, "run_api", lambda backend, port: seen.update(b=backend, p=port))
    tcli.cmd_api(_yaml(tmp_path, "api", config_preset="tiny", bf16=False, draft_k=3), port=8123,
                 device="cpu")
    backend = seen["b"]
    assert seen["p"] == 8123 and isinstance(backend, tapi.ChatBackend) and backend.draft_k == 3
    assert backend.generator.device == torch.device("cpu") and backend.generator.cfg == TCFG
    ids = backend.generator.generate(np.asarray([[5, 6, 7]]), max_new_tokens=2, temperature=0.0)
    assert ids.shape == (1, 2)


@pytest.mark.parametrize("recipe", ["sft_tiny.yaml", "dt_stage1_tiny.yaml", "rm_tiny.yaml",
                                    "dpo_tiny.yaml", "kto_tiny.yaml"])
def test_train_command_runs_the_recipe(tmp_path, recipe):
    conf = yaml.safe_load(open(os.path.join(REPO, "examples", recipe)))
    conf.update(output_dir=str(tmp_path / "out"), dataset_dir=os.path.join(REPO, "data"),
                max_steps=2)
    tcli.cmd_train(_yaml(tmp_path, "train", **conf), device="cpu")
    recs = [json.loads(line) for line in open(tmp_path / "out" / "trainer_log.jsonl")]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()


SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|vision_start|>",
            "<|vision_end|>", "<|image_pad|>", "<|video_pad|>"]


def test_resolve_tokenizer_gives_jax_ids(tmp_path):
    """Tokenizer files under model_name_or_path are picked up through
    `transformers` by both packages: the same ids."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(
        ["What is the capital of France? Answer: A B C D", "2 + 3 x 7 - 100 / 81"],
        trainers.BpeTrainer(vocab_size=300, special_tokens=["<unk>"] + SPECIALS))
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", eos_token=SPECIALS[0],
                            additional_special_tokens=SPECIALS[1:]).save_pretrained(
        str(tmp_path))
    conf = {"model_name_or_path": str(tmp_path), "config_preset": "tiny"}
    t = tresolve(thparams.parse_args(conf), TCFG)
    j = jresolve(jhparams.parse_args(conf), CFG)
    assert not isinstance(t, TTok)
    for text in ("What is 2 + 3?\nAnswer: B", "<|im_start|>user capital<|im_end|>"):
        assert t.encode(text, add_special_tokens=False) == j.encode(text,
                                                                   add_special_tokens=False)
    ev = tmcq.MCQEvaluator(None, t)
    assert len(set(ev.choice_ids)) == 4
