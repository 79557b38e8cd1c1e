"""Sequence-axis pipeline microbatching (TeraPipe-style) for training
(torch port of infinitevl_tpu/parallel/pipeline_seq.py).

The batch-axis schedules (parallel/pipeline.py) need B >= n_microbatches,
which leaves pipeline parallelism useless for B = 1 long-context SFT. Here
the microbatches are contiguous sequence chunks: every layer of the
deployed config is local or recurrent (sliding-window attention, gated
DeltaNet), so what crosses a chunk edge is a small per-layer carry (the
previous window's post-RoPE K/V and segment ids, or the fp32 delta state
and the conv tails), threaded by models/text.decoder_layer_chunk_forward.

Schedule (GPipe): chunk c enters stage 0 before chunk c + 1, and stage s
runs chunk c after stage s - 1; a stage's carry advances only on a real
chunk (each chunk's forward takes the carry its previous chunk left).
The backward runs the chunks in reverse: on each stage, chunk c's
backward takes the gradient of its output from stage s + 1 and the
gradient of its carry from chunk c + 1's backward on the same rank, so the
carry's gradient flows c + 1 -> c before chunk c's input gradient goes
back to stage s - 1. Stage cut, hand-offs, the embedding and the head are
pipeline.py's.

Constraints: T % M == 0 and the chunk T / M a multiple of the sliding
window (the SWA carry holds one window), the gpipe schedule only."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TextConfig
from ..models.text import decoder_layer_chunk_forward, embed_tokens, init_layer_seq_carry
from ..ops.norms import rms_norm
from ..ops.rope import mrope_cos_sin
from .pipeline import _ce_chunk, _mesh_scope, _Run, apply_pipeline_grads, stack_stage_params
from .sharding import Mesh, gather_tree

Params = Dict[str, Any]


def _check_chunks(T: int, M: int, cfg: TextConfig) -> int:
    if T % M:
        raise ValueError(f"T={T} not divisible by {M} sequence chunks")
    Tc = T // M
    if Tc % cfg.sliding_window:
        raise ValueError(f"sequence chunk {Tc} must be a multiple of the sliding window "
                         f"{cfg.sliding_window} (T={T}, M={M})")
    return Tc


def init_stage_carries(stage_layers: Sequence[Sequence[Params]], cfg: TextConfig, B: int,
                       dtype, device=None, stages: Optional[Sequence[int]] = None
                       ) -> Dict[int, List[Tuple]]:
    """Zero carries of every layer of each stage in `stages` (default:
    all), {stage: [carry of each of its layers]}: what a layer's first
    chunk starts from (models/text.init_layer_seq_carry, on the layer's
    local head counts; a data-sharded layer is gathered for its shapes)."""
    n = len(stage_layers[0])
    out = {}
    for s in (range(len(stage_layers)) if stages is None else stages):
        with torch.no_grad():
            out[s] = [init_layer_seq_carry(gather_tree(lp), cfg, cfg.layer_role(s * n + i), B,
                                           dtype, device)
                      for i, lp in enumerate(stage_layers[s])]
    return out


def _stage_chunk_fn(layers, carries, cfg: TextConfig, first: int, x, cos, sin, segment_ids,
                    remat: bool):
    """One stage over one chunk: its layers in order, each threading its
    cross-chunk carry in and out (a checkpoint a layer under remat when
    differentiated). Returns (x', [carry' of each layer])."""
    out = []
    for i, (lp, c) in enumerate(zip(layers, carries)):
        def layer(lp, x, c, role=cfg.layer_role(first + i)):
            return decoder_layer_chunk_forward(gather_tree(lp), cfg, role, x, cos, sin,
                                               segment_ids, c)

        if remat and torch.is_grad_enabled():
            x, c2 = checkpoint(layer, lp, x, c, use_reentrant=False)
        else:
            x, c2 = layer(lp, x, c)
        out.append(c2)
    return x, out


def seq_pipeline_decoder_forward(
    stage_layers: Sequence[Sequence[Params]],
    cfg: TextConfig,
    x_mb: torch.Tensor,  # [M, B, Tc, D] sequence-chunked embeddings, in order
    cos_mb: torch.Tensor,  # [M, B, Tc, head_dim]
    sin_mb: torch.Tensor,
    segment_ids_mb: Optional[torch.Tensor] = None,  # [M, B, Tc]
    mesh: Optional[Mesh] = None,
    remat: bool = True,
) -> torch.Tensor:
    """The wavefront over sequence chunks in one process, differentiable:
    at tick t stage s runs chunk t - s from the carries its chunk t - s - 1
    left. Returns [M, B, Tc, D] hidden states (pre-final-norm)."""
    if mesh is not None and mesh.pipe > 1:
        raise ValueError("seq_pipeline_decoder_forward runs every stage in one process; on a "
                         "pipe mesh use seq_pp_sft_value_and_grad")
    S, M, B = len(stage_layers), x_mb.shape[0], x_mb.shape[1]
    n = len(stage_layers[0])
    carries = init_stage_carries(stage_layers, cfg, B, x_mb.dtype, x_mb.device)
    state: List[Optional[torch.Tensor]] = [None] * S
    out: List[Optional[torch.Tensor]] = [None] * M
    for t in range(M + S - 1):
        nxt: List[Optional[torch.Tensor]] = [None] * S
        for s in range(S):
            c = t - s
            if 0 <= c < M:  # a real chunk: only then does the stage's carry advance
                seg = None if segment_ids_mb is None else segment_ids_mb[c]
                y, carries[s] = _stage_chunk_fn(stage_layers[s], carries[s], cfg, s * n,
                                                x_mb[c] if s == 0 else state[s], cos_mb[c],
                                                sin_mb[c], seg, remat)
                if s == S - 1:
                    out[c] = y
                else:
                    nxt[s + 1] = y
        state = nxt
    return torch.stack(out)


def seq_pp_sft_loss_fn(
    pp_text_params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,  # [B, T]
    labels: torch.Tensor,  # [B, T]
    position_ids: torch.Tensor,  # [3, B, T]
    n_microbatches: int,
    segment_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
) -> torch.Tensor:
    """SFT loss with the microbatch axis on the sequence, in one process,
    differentiable: T is split into n_microbatches contiguous chunks
    (T % M == 0 and (T / M) % window == 0). B is unconstrained."""
    from ..train.step import fused_linear_cross_entropy, head_weight

    B, T = input_ids.shape
    M = n_microbatches
    Tc = _check_chunks(T, M, cfg)
    embeds = embed_tokens(pp_text_params, input_ids)
    cos, sin = mrope_cos_sin(position_ids, pp_text_params["inv_freq"], cfg.mrope_section,
                             cfg.attention_scaling, dtype=embeds.dtype)

    def chunk(a):  # [B, T, ...] -> [M, B, Tc, ...]
        return a.reshape((B, M, Tc) + tuple(a.shape[2:])).movedim(1, 0)

    hidden = seq_pipeline_decoder_forward(
        pp_text_params["stage_layers"], cfg, chunk(embeds), chunk(cos), chunk(sin),
        None if segment_ids is None else chunk(segment_ids), mesh=mesh, remat=remat)
    hidden = hidden.movedim(0, 1).reshape(B, T, -1)
    hidden = rms_norm(hidden, pp_text_params["final_norm"], cfg.rms_norm_eps)
    w, tied = head_weight(pp_text_params)
    return fused_linear_cross_entropy(hidden, w, labels, chunk=_ce_chunk(T), w_is_vd=tied)


def _floats(carries) -> List[torch.Tensor]:
    """The differentiable tensors of a stage's carries, in order (the
    segment ids they hold are integers)."""
    return [t for c in carries for t in c if t.is_floating_point()]


def _cut(carries) -> List[Tuple]:
    """The carries cut from the graph, their float tensors requiring grad
    (the next chunk's inputs, differentiated in its backward)."""
    return [tuple(t.detach().requires_grad_(t.is_floating_point()) for t in c) for c in carries]


def seq_pp_sft_value_and_grad(
    pp_text_params: Params,
    cfg: TextConfig,
    input_ids: torch.Tensor,
    labels: torch.Tensor,
    position_ids: torch.Tensor,
    n_microbatches: int,
    segment_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
    segment_layout: Optional[str] = None,
):
    """The sequence-axis GPipe with its backward: (loss, gradients of
    trainable_leaves(pp_text_params) in that order), in one process or on
    a pipe mesh. Each chunk's forward through this process's stages in
    order (graphs kept), then the chunks' backwards in reverse, each from
    the gradient of its output (the next stage's, or the head's) and of its
    carries (its next chunk's backward on the same stage)."""
    B, T = input_ids.shape
    _check_chunks(T, n_microbatches, cfg)
    with _mesh_scope(mesh):
        run = _Run(pp_text_params, cfg, input_ids, labels, position_ids, n_microbatches,
                   segment_ids, segment_layout, mesh, remat, axis=1)
        S, layers = run.S, pp_text_params["stage_layers"]
        carries = init_stage_carries(layers, cfg, B, pp_text_params["embed"].dtype,
                                     input_ids.device, run.stages)
        kept = {}
        with torch.enable_grad():
            for c in range(run.M):
                for s in run.stages:
                    x = run.stage_input(s, c, grad=True)
                    cos, sin, seg = run.pieces(c)
                    c_in = carries[s]
                    y, c_out = _stage_chunk_fn(layers[s], c_in, cfg, s * run.per_stage, x, cos,
                                               sin, seg, remat)
                    carries[s] = _cut(c_out)
                    if s == S - 1:
                        y = run.head_nll(c, y)
                        run.loss += y.detach().float()
                    else:
                        run.hand_act(s, c, y)
                    kept[(s, c)] = (x, c_in, y, c_out)
        d_carry: Dict[int, List[torch.Tensor]] = {}
        for c in reversed(range(run.M)):
            for s in reversed(run.stages):
                x, c_in, y, c_out = kept.pop((s, c))
                last = s == S - 1
                outs, cts = [y], [None if last else run.take_ct(s, c)]
                if s in d_carry:  # the carry's gradient from chunk c + 1
                    pairs = [(o, g) for o, g in zip(_floats(c_out), d_carry.pop(s))
                             if g is not None]
                    outs += [o for o, _ in pairs]
                    cts += [g for _, g in pairs]
                ins = _floats(c_in)
                grads = run.backward(outs, cts, [x] + ins,
                                     run.leaves[s] + (run.head_leaves() if last else []))
                if c > 0:
                    d_carry[s] = grads[1:]
                run.hand_ct(s, c, grads[0])
        return run.finish()


def make_seq_pp_sft_train_step(
    cfg: TextConfig,
    tx,
    n_microbatches: int,
    n_stages: int,
    mesh: Optional[Mesh] = None,
    remat: bool = True,
):
    """Sequence-microbatched pipelined step, the signature of
    pipeline.make_pp_sft_train_step (the gpipe schedule): params and the
    optimizer state updated in place."""
    from ..train.step import batch_to_device, tree_device

    def step(params, opt_state, batch):
        batch = batch_to_device(batch, tree_device(params))
        pp = stack_stage_params(params["text"], cfg, n_stages)
        loss, grads = seq_pp_sft_value_and_grad(
            pp, cfg, batch["input_ids"], batch["labels"], batch["position_ids"],
            n_microbatches, segment_ids=batch.get("segment_ids"), mesh=mesh, remat=remat,
            segment_layout=batch.get("segment_layout"))
        apply_pipeline_grads(pp, grads, params, tx, opt_state)
        return params, opt_state, loss

    return step
