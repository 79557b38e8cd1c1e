"""What the ranks of tests/test_torch_port_parallel.py run: importable by the
processes that infinitevl_tpu_torch.parallel.launch.spawn_ranks starts, and
free of jax, so a rank loads the port alone. The JAX side's numbers
(weights, adapters, the converted student's fresh mixers) come in as
numpy trees and are patched into the port's workflows, so both packages
train from the same numbers."""

import contextlib
import dataclasses
import json
import os

import torch

N_LAYERS = 2  # the tiny preset cut to one SWA and one DeltaNet layer


def tiny_cut():
    from infinitevl_tpu_torch.config import tiny_config

    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=N_LAYERS, layer_types=cfg.text.layer_types[:N_LAYERS]))


def losses(out_dir, key="loss"):
    """The logged step losses (or eval losses) of a run (none for a run that
    took no step)."""
    path = os.path.join(out_dir, "trainer_log.jsonl")
    if not os.path.exists(path):
        return []
    return [r[key] for r in map(json.loads, open(path)) if key in r]


def leaves_np(tree):
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    return {k: v.detach().cpu().numpy() for k, v in tree_leaves_with_path(tree)}


@contextlib.contextmanager
def patched(carry):
    """The port's run_sft / run_dt starting from the carried numbers for the
    duration of a `with`: the cut tiny preset, the model's (or the
    teacher's) weights, the adapters, and the converted student's fresh
    mixers. Everything patched is restored on exit."""
    import infinitevl_tpu_torch.train.lora as tlora
    import infinitevl_tpu_torch.train.trainer as ttrainer
    from infinitevl_tpu_torch.models.params import from_jax_numpy

    saved = [(ttrainer, "tiny_config", ttrainer.tiny_config)]
    ttrainer.tiny_config = tiny_cut
    if "params" in carry:
        saved.append((ttrainer, "_load_or_init_params", ttrainer._load_or_init_params))
        ttrainer._load_or_init_params = (
            lambda args, cfg, mm, dtype, device: from_jax_numpy(carry["params"], device))
    if "teacher" in carry:
        saved.append((ttrainer, "init_text_params", ttrainer.init_text_params))
        ttrainer.init_text_params = lambda cfg, gen, device, dtype: from_jax_numpy(
            carry["teacher"], device)
    if "lora" in carry:
        saved.append((tlora, "init_lora", tlora.init_lora))
        tlora.init_lora = lambda params, gen, **kw: from_jax_numpy(carry["lora"], "cpu",
                                                                   trainable=True)
    if "student" in carry:
        real = ttrainer.convert_attention
        saved.append((ttrainer, "convert_attention", real))

        def convert(teacher, cfg, gen, softmax_attention, mixer):
            student, scfg = real(teacher, cfg, gen, softmax_attention=softmax_attention,
                                 mixer=mixer)
            carried = from_jax_numpy(carry["student"], "cpu")
            for i, lp in enumerate(student["layers"]):
                if i not in softmax_attention:
                    for k in list(lp):
                        if k not in ("mlp", "input_norm", "post_norm"):
                            lp[k] = carried["layers"][i][k]
            return student, scfg

        ttrainer.convert_attention = convert
    try:
        yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def run_job(job):
    """One run_exp (job["conf"]: a yaml dict) from the carried numbers:
    {"final": its returned params as numpy, "losses": rank 0's log}."""
    from infinitevl_tpu_torch.hparams import parse_args
    from infinitevl_tpu_torch.parallel.sharding import world_rank
    from infinitevl_tpu_torch.train.trainer import run_exp

    args = parse_args(job["conf"])
    with patched(job.get("carry", {})):
        final = run_exp(args, device="cpu")
    out = {"final": leaves_np(final)}
    if world_rank() == 0:
        out["losses"] = losses(args.train.output_dir)
        out["eval"] = losses(args.train.output_dir, "eval_loss")
    return out


def global_ce_parts(rows):
    """Each rank's part of the CE of a global batch whose rows hold
    different numbers of supervised tokens (its rows: logits, labels)."""
    from infinitevl_tpu_torch.parallel.sharding import Mesh, use_mesh
    from infinitevl_tpu_torch.train.step import cross_entropy_loss

    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    logits, labels = rows
    n = logits.shape[0] // world
    mine = slice(rank * n, (rank + 1) * n)
    with use_mesh(Mesh(world, 1, rank)):
        part = cross_entropy_loss(torch.from_numpy(logits[mine]), torch.from_numpy(labels[mine]))
    return float(part)


def cli_train(path):
    """`cli train` on a recipe file (the world already joined: the launcher's
    group is the one torchrun would make); rank 0's logged losses."""
    from infinitevl_tpu_torch.cli import cmd_train
    from infinitevl_tpu_torch.hparams import load_yaml_args
    from infinitevl_tpu_torch.parallel.sharding import world_rank

    with patched({}):
        cmd_train(path, device="cpu")
    return losses(load_yaml_args(path).train.output_dir) if world_rank() == 0 else None


def jobs(rank, world, job_list):
    """Run each job in order: a run_exp ("run"), the CE check ("ce") or a
    `cli train` ("cli")."""
    out = []
    for job in job_list:
        if job["kind"] == "ce":
            out.append(global_ce_parts(job["rows"]))
        elif job["kind"] == "cli":
            out.append(cli_train(job["path"]))
        else:
            out.append(run_job(job))
    return out


def raise_on_rank0(rank, world):
    """Rank 0 raises; the other ranks wait in a collective that never
    completes: the launcher must fail within its deadline."""
    if rank == 0:
        raise RuntimeError("rank 0 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))
    return None
