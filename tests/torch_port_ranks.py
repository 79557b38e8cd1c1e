"""What the ranks of tests/test_torch_port_parallel.py, test_torch_port_tp_*.py
and test_torch_port_pipeline_ranks.py run: importable by the
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


# the sequence-chunk knobs of tests/test_torch_port_longctx.py: sft_tiny.yaml's
# cutoff of 64 then runs the chunked SWA, DeltaNet and MLP layers
CHUNKED = dict(sliding_window=16, delta_chunk_size=8, delta_seq_chunk_t=32,
               delta_seq_chunk_eval=16, mlp_chunk_t=16)


def tiny_cut(chunked=False, layers=N_LAYERS):
    from infinitevl_tpu_torch.config import tiny_config

    cfg = tiny_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers, layer_types=cfg.text.layer_types[:layers],
        **(CHUNKED if chunked else {})))


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
    duration of a `with`: the cut tiny preset (carry["layers"] deep, default
    N_LAYERS; with the sequence-chunk knobs where carry["chunked"]), the
    model's (or the
    teacher's) weights, the adapters, and the converted student's fresh
    mixers. Everything patched is restored on exit."""
    import infinitevl_tpu_torch.train.lora as tlora
    import infinitevl_tpu_torch.train.trainer as ttrainer
    from infinitevl_tpu_torch.models.params import from_jax_numpy
    from infinitevl_tpu_torch.train.step import tree_leaves_with_path

    saved = [(ttrainer, "tiny_config", ttrainer.tiny_config)]
    ttrainer.tiny_config = lambda: tiny_cut(carry.get("chunked", False),
                                            carry.get("layers", N_LAYERS))
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
    if "apollo_draws" in carry:  # JAX's projections, by leaf path and window
        import infinitevl_tpu_torch.train.optim as toptim

        real_init = toptim.Apollo.__init__
        saved.append((toptim.Apollo, "__init__", real_init))
        draws = carry["apollo_draws"]

        def init(self, *a, **kw):
            kw["projection"] = lambda path, index, window, d, rank, device: torch.from_numpy(
                draws[path][window]).to(device)
            real_init(self, *a, **kw)

        toptim.Apollo.__init__ = init
    if "student" in carry:
        real = ttrainer.convert_attention
        saved.append((ttrainer, "convert_attention", real))

        def convert(teacher, cfg, gen, softmax_attention, mixer):
            student, scfg = real(teacher, cfg, gen, softmax_attention=softmax_attention,
                                 mixer=mixer)
            carried = from_jax_numpy(carry["student"], "cpu")
            shared = {id(t) for _, t in tree_leaves_with_path(teacher)}
            for i, lp in enumerate(student["layers"]):
                if i not in softmax_attention:
                    for k in list(lp):
                        # a leaf the conversion shares with the teacher (Mamba2's
                        # q / o_proj, copies in JAX) stays shared, as run_dt has it
                        if k not in ("mlp", "input_norm", "post_norm") and not all(
                                id(t) in shared for _, t in tree_leaves_with_path(lp[k])):
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
    {"final": its returned params as numpy, "losses": rank 0's log,
    "delta_chunks": the sequence-chunked DeltaNet chunks it ran}."""
    from infinitevl_tpu_torch.hparams import parse_args
    from infinitevl_tpu_torch.parallel.sharding import world_rank
    from infinitevl_tpu_torch.train.trainer import run_exp

    import infinitevl_tpu_torch.models.text as ttext

    args = parse_args(job["conf"])
    calls = []
    real = ttext._delta_chunk
    ttext._delta_chunk = lambda *a: calls.append(1) or real(*a)
    try:
        with patched(job.get("carry", {})):
            final = run_exp(args, device="cpu")
    finally:
        ttext._delta_chunk = real
    out = {"final": leaves_np(final), "delta_chunks": len(calls)}
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


def pp_grads(job):
    """One pipelined loss-and-gradient evaluation on this world's (pipe,
    data, model) mesh (tests/test_torch_port_pipeline_ranks.py): the tiny
    preset from seed 0 in fp32, full finetuning's trainable leaves, the
    rank's stage sharded under job["mode"], the rank's rows of the global
    batch job["batch"] (numpy), job["schedule"] gpipe / 1f1b / seq.
    Returns the global loss, the clip's squared global norm and, on rank 0,
    every gradient as the optimizer takes it (summed over the data group)
    whole (over the data and model slices and the stages), by one-process
    path."""
    import torch

    from infinitevl_tpu_torch.config import tiny_config
    from infinitevl_tpu_torch.models.params import init_text_params
    from infinitevl_tpu_torch.parallel import pipeline as pl
    from infinitevl_tpu_torch.parallel import sharding as sh
    from infinitevl_tpu_torch.parallel.pipeline_seq import seq_pp_sft_value_and_grad
    from infinitevl_tpu_torch.train.step import (
        full_finetune_leaf,
        set_trainable,
        trainable_leaves,
    )
    from infinitevl_tpu_torch.utils.checkpoint import tree_map

    S, data, model = job["mesh"]
    mesh = sh.create_pp_mesh(S, data, model)
    cfg = tiny_config().text
    text = init_text_params(cfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    set_trainable({"text": text}, full_finetune_leaf)
    params = {"text": pl.shard_stage(text, cfg, S, mesh, job["mode"])}
    b = sh.rank_rows(dict(job["batch"]), mesh)
    ids, labels, pos, seg = (torch.as_tensor(b[k]) for k in ("input_ids", "labels",
                                                              "position_ids", "segment_ids"))
    fn = {"gpipe": pl.pp_sft_value_and_grad_gpipe, "1f1b": pl.pp_sft_value_and_grad_1f1b,
          "seq": seq_pp_sft_value_and_grad}[job["schedule"]]
    pp = pl.stack_stage_params(params["text"], cfg, S)
    with sh.use_mesh(mesh):
        loss, grads = fn(pp, cfg, ids, labels, pos, job["M"], seg, mesh=mesh)
        loss = sh.global_sum(loss)
        by_id = {id(t): g for (_, t), g in zip(trainable_leaves(pp), grads)}
        leaves = [t for _, t in trainable_leaves(params)]
        # the optimizer's view: the replicated leaves' sums over the data group
        synced = sh.sync_gradients(leaves, [by_id[id(t)] for t in leaves])
        by_id = {id(t): g for t, g in zip(leaves, synced)}
        sq = sh.grad_sq_norm(leaves, synced)
        gtree = tree_map(lambda t: sh.copy_shard_info(by_id[id(t)].detach(), t)
                            if id(t) in by_id else None, params)
        whole = pl.gather_stages(gtree, mesh)
    out = {"loss": float(loss), "grad_sq_norm": float(sq)}
    if sh.world_rank() == 0:
        out["grads"] = leaves_np(whole)
    return out


def jobs(rank, world, job_list):
    """Run each job in order: a run_exp ("run"), the CE check ("ce"), a
    `cli train` ("cli"), a pipelined gradient ("pp_grads"), the forwards
    under tensor parallelism ("tp_forwards") or an optimizer's update on
    slices ("sliced_update")."""
    out = []
    for job in job_list:
        if job["kind"] == "ce":
            out.append(global_ce_parts(job["rows"]))
        elif job["kind"] == "cli":
            out.append(cli_train(job["path"]))
        elif job["kind"] == "pp_grads":
            out.append(pp_grads(job))
        elif job["kind"] == "tp_forwards":
            out.append(tp_forwards(rank, world, [job])[0])
        elif job["kind"] == "sliced_update":
            out.append(sliced_update(job))
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


def tp_forwards(rank, world, jobs):
    """Each job's forwards under tensor parallelism (tests/test_torch_port_tp_model.py):
    the mesh (data, model) over this world, the port's config, the numpy
    weights and inputs; returns per job the whole hidden states and logits
    of the stateless forward, the ViT's features where the job has pixels,
    and with job["cached"] the prefill and greedy decode steps on this
    rank's part of the state (logits, tokens, the state gathered whole, the
    rank's part, and whether cutting the whole state again gives the part
    bit for bit)."""
    from infinitevl_tpu_torch.generation import decode_step, prefill
    from infinitevl_tpu_torch.models.infinitevl import encode_vision
    from infinitevl_tpu_torch.models.params import from_jax_numpy
    from infinitevl_tpu_torch.models.state import init_decoder_state
    from infinitevl_tpu_torch.models.text import embed_tokens, lm_head, text_forward
    from infinitevl_tpu_torch.parallel import sharding as sh

    out = []
    for job in jobs:
        data, model = job["mesh"]
        mesh = sh.create_mesh(data, model)
        cfg = job["cfg"]
        params = sh.shard_params(from_jax_numpy(job["params"], "cpu"), mesh, "tp")
        res = {"held": sh.local_bytes(params)}
        ids, pos = torch.as_tensor(job["ids"]), torch.as_tensor(job["pos"])
        if job.get("stateless", True):
            h, _ = text_forward(params["text"], cfg.text, embed_tokens(params["text"], ids), pos)
            res["hidden"] = h.numpy()
            res["logits"] = lm_head(params["text"], cfg.text, h).numpy()
        if "pixels" in job:
            res["vit"] = encode_vision(params, cfg, torch.as_tensor(job["pixels"]),
                                       job["grid"]).numpy()
        if "labels" in job:
            res.update(tp_grads(job, mesh))
        if job.get("cached"):
            B = ids.shape[0]
            hq = cfg.text.num_attention_heads
            state = init_decoder_state(cfg.text, B, torch.float32, "cpu", mesh=mesh)
            logits, state = prefill(params, cfg, ids, pos, state)
            steps, tokens = [logits.numpy()], []
            zero = torch.zeros((B, 1), dtype=torch.long)
            for _ in range(job["cached"]):
                tok = logits.argmax(-1, keepdim=True)
                tokens.append(tok.numpy())
                logits, state = decode_step(params, cfg, tok, zero, state)
                steps.append(logits.numpy())
            whole_shapes = {k: tuple(v.shape) for k, v in init_decoder_state(
                cfg.text, B, torch.float32, "cpu").items() if isinstance(v, torch.Tensor)}
            whole = sh.gather_state(state, mesh, hq, whole_shapes)
            again = sh.shard_state(whole, mesh, hq)
            res.update(steps=steps, tokens=tokens, cum_len=state["cum_len"],
                       state={k: v.numpy() for k, v in whole.items()
                              if isinstance(v, torch.Tensor)},
                       part={k: v.numpy() for k, v in state.items()
                             if isinstance(v, torch.Tensor)},
                       roundtrip=all(torch.equal(again[k], state[k]) for k in whole_shapes))
        out.append(res)
    return out


def tp_grads(job, mesh):
    """The SFT loss's gradient with respect to every leaf of the model
    (each leaf trainable, sharded as `tp`) and its squared global norm, and
    with respect to the LoRA
    factors job["lora"] where the job has them (rank job["lora_rank"],
    alpha 16; DoRA's where they carry `m`) on the frozen sharded model:
    every gradient whole (a slice's gathered over the model
    group), as numpy by path."""
    from infinitevl_tpu_torch.models.params import from_jax_numpy
    from infinitevl_tpu_torch.parallel import sharding as sh
    from infinitevl_tpu_torch.train.lora import attach_lora
    from infinitevl_tpu_torch.train.step import sft_loss_fn, tree_leaves_with_path

    cfg = job["cfg"].text
    ids, labels, pos = (torch.as_tensor(job[k]) for k in ("ids", "labels", "pos"))
    out = {}
    params = from_jax_numpy(job["params"], "cpu", trainable=True)
    params = sh.shard_params({"text": params["text"]}, mesh, "tp")
    named = list(tree_leaves_with_path(params))
    grads = torch.autograd.grad(sft_loss_fn(params["text"], cfg, ids, labels, pos),
                                [t for _, t in named], allow_unused=True)
    out["grads"] = {k: sh.gather_full(sh.copy_shard_info(g, t)).numpy()
                    for (k, t), g in zip(named, grads) if g is not None}
    # the clip's squared global norm over the slices (a slice's squares summed
    # over the model group, a replicated leaf once)
    have = [(t, g) for (_, t), g in zip(named, grads) if g is not None]
    out["grad_sq_norm"] = float(sh.grad_sq_norm([t for t, _ in have], [g for _, g in have]))
    if "lora" not in job:
        return out
    base = sh.shard_params({"text": from_jax_numpy(job["params"], "cpu")["text"]}, mesh, "tp")
    lora = from_jax_numpy(job["lora"], "cpu", trainable=True)
    named = list(tree_leaves_with_path(lora))
    merged = attach_lora(base, lora, 16.0, job["lora_rank"])
    grads = torch.autograd.grad(sft_loss_fn(merged["text"], cfg, ids, labels, pos),
                                [t for _, t in named])
    out["lora_grads"] = {k: g.numpy() for (k, _), g in zip(named, grads)}
    return out


def sliced_update(job):
    """Two updates of the optimizer job["name"] (train/optim.py, keyword
    arguments job["kw"]) on this rank's slices of job["leaves"] (numpy, by
    path), sliced on the (data, model) mesh job["mesh"] under job["mode"],
    fed this rank's slices of the whole gradients job["grads"] (a list of
    steps; under fsdp a data-axis shard's gradient comes summed, so the
    whole gradient is cut as it is; a leaf whole over data takes its half
    of the data group's sum, which `sync_gradients` adds back): the leaves
    after the updates, gathered whole, and the optimizer state in the
    one-process format (gather_opt_state)."""
    from infinitevl_tpu_torch.parallel import sharding as sh
    from infinitevl_tpu_torch.train.optim import make_custom_optimizer
    from infinitevl_tpu_torch.train.step import trainable_leaves

    data, model = job["mesh"]
    mesh = sh.create_mesh(data, model)
    tree = {"text": {k: torch.from_numpy(v).requires_grad_(True)
                     for k, v in job["leaves"].items()}}
    tree = sh.shard_params(tree, mesh, job["mode"])
    tx = make_custom_optimizer(job["name"], 1e-2, **job["kw"])
    with sh.use_mesh(mesh):
        state = tx.init(tree)
        named = trainable_leaves(tree)
        for grads in job["grads"]:
            g = []
            for path, t in named:
                full = torch.from_numpy(grads[path.split("/", 1)[1]])
                if sh.shard_info(t) is None:
                    full = full / data
                g.append(sh.slice_like(full, t).clone())
            tx.update(g, state, tree)
        leaves = [t for _, t in named]
        whole = {path: sh.whole_like(t.detach(), t).numpy() for path, t in named}
        opt = sh.gather_opt_state(state, leaves)
    return {"leaves": whole, "state": _np_tree(opt)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree
