"""The TSPM baseline (Temporal-Spatial Perception Model), PyTorch edition.

Port of ``qa_tiger_tpu/models/tspm.py``: five input projections -> AV_Attn
(one AVHanLayer, one head, both directions as one 2B batch over the
original projections) -> TemporalPerception (the QA prompt as the query, a
discrete top-K of frames) -> SpatioPerception (audio-guided attention over
the selected frames' patch tokens) -> QstTemporalGrounding (one parameter
set for the audio and the visual call) -> a 6-way concat [B, 6h] -> tanh ->
Linear(6h, h) -> times the question -> tanh -> Linear(h, num_labels).

Submodules carry the JAX pytree's names (``AV_Attn.layers.0.cm_attn``,
``SpatioPerception.TokensAttn.norm1``, ``QstTempGrd_Module.qst_query_linear1``),
so a strict ``load_state_dict`` takes ``params_from_jax(tspm_init(...))``.

TSPM reads precomputed question and QA-prompt features (``quest`` and
``prompt`` [B, Dq] or [B, 1, Dq], from the ``questions`` and ``prompts``
extraction stages); token ids raise ``NotImplementedError``, as the JAX
forward does. Its attentions run through ``mha``: the ones that ask for no
weights reach ``attention_wide`` in eval (AV_Attn's and TokensAttn's at one
head of 512 lanes, the grounding calls at four of 128); TemporalPerception
asks for the head-averaged weights and runs the plain path.

The top-K is the JAX one: a stable ascending argsort, the last K, sorted in
time (``topk_time_indices``); on ties the higher frame index wins the last
slot. Dropout (p 0.1, fixed as in the reference) draws from one
``torch.Generator`` per site (``SITES``), as QA-TIGER's does, so that the
train step's CUDA graph can own and reseed them.

Under a ``grid`` of model size tp > 1 (``parallel/tensor.py``) the model
holds this rank's shards (``tp_spec``: every ``in_proj_*`` by lanes of q,
k and v, ``out_proj.weight`` by row, AVHanLayer's and TokensSelfAttn's
``linear1`` by column and ``linear2`` by row; the rest whole) and every
block runs its tensor-parallel form: the one-head attentions split by
lanes and the four-head ones by head (``mha``), each FFN as a column
``linear1``, ReLU, dropout on the rank's columns of the whole mask and a
row ``linear2`` summed over the group (``_ffn``). TemporalPerception's
weights are summed over the group before the top-K, so every rank selects
the same frames. Each dropout site draws its whole realization from its
generator in the single process's order and keeps the rank's share.
``TSPM.check_model_parallel`` says whether a tp splits the config.
"""
from __future__ import annotations

import torch
from torch import nn

from qa_tiger_tpu_torch.models.qa_tiger import split_generator
from qa_tiger_tpu_torch.nn.attention import MultiheadAttention, mha
from qa_tiger_tpu_torch.nn.core import LayerNorm, Linear, dropout
from qa_tiger_tpu_torch.parallel.tensor import copy_to_model, row_linear

TSPM_FROZEN_PREFIXES: tuple[str, ...] = ()
# the dropout sites of one forward (AV_Attn, TemporalPerception,
# SpatioPerception, QstTempGrd_Module), each with its own generator
SITES = 4
# the heads of the AttnFFN attentions (TemporalPerception, SpatioPerception's
# query, QstTempGrd_Module); AV_Attn and TokensAttn are one head
ATTN_FFN_HEADS = 4
TOKEN_IDS_REFUSED = (
    "TSPM requires precomputed question/prompt features (the reference's token path "
    "references a nonexistent quest_encoder, src/models/tspm.py:375)")


def tspm_config(topK: int = 10, audio_dim: int = 128, vis_dim: int = 768,
                patch_dim: int = 1024, qst_dim: int = 768, hidden_size: int = 512,
                num_labels: int = 42, avq_cross_attn: bool = False, **_unused) -> dict:
    """The JAX ``tspm_config`` (dropout fixed at 0.1), plus ``arch`` for the
    registry."""
    return dict(topK=topK, audio_dim=audio_dim, vis_dim=vis_dim, patch_dim=patch_dim,
                qst_dim=qst_dim, hidden_size=hidden_size, num_labels=num_labels,
                avq_cross_attn=avq_cross_attn, dropout=0.1, arch="TSPM")


def _linear(d_in: int, d_out: int, g: torch.Generator) -> Linear:
    return Linear(d_in, d_out, g, init="torch")


class AttnFFN(nn.Module):
    """MHA, then a residual ReLU FFN and LayerNorm (the reference's
    QstQueryClipAttn): ``attn_qst_query``, ``qst_query_linear1/2``,
    ``qst_query_visual_norm``."""

    def __init__(self, d: int, g: torch.Generator):
        super().__init__()
        self.attn_qst_query = MultiheadAttention(d, g)
        self.qst_query_linear1 = _linear(d, d, g)
        self.qst_query_linear2 = _linear(d, d, g)
        self.qst_query_visual_norm = LayerNorm(d)


class AVHanLayer(nn.Module):
    """One cross- plus self-attention block with a ReLU FFN."""

    def __init__(self, d: int, d_ff: int, g: torch.Generator):
        super().__init__()
        self.self_attn = MultiheadAttention(d, g)
        self.cm_attn = MultiheadAttention(d, g)
        self.linear1 = _linear(d, d_ff, g)
        self.linear2 = _linear(d_ff, d, g)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class TokensSelfAttn(nn.Module):
    """The patch tokens' self-attention block (no cross-attention)."""

    def __init__(self, d: int, g: torch.Generator):
        super().__init__()
        self.self_attn = MultiheadAttention(d, g)
        self.linear1 = _linear(d, d, g)
        self.linear2 = _linear(d, d, g)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class AVAttn(nn.Module):
    """``AV_Attn``: ``layers.0`` and the reference's two unused norms."""

    def __init__(self, d: int, g: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleDict({"0": AVHanLayer(d, d, g)})
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class SpatioPerception(AttnFFN):
    def __init__(self, d: int, g: torch.Generator):
        super().__init__(d, g)
        self.TokensAttn = TokensSelfAttn(d, g)


def _ffn(x, lin1: Linear, lin2: Linear, dp: float, gen, grid=None) -> torch.Tensor:
    """lin2(dropout(relu(lin1(x)))); under a model axis lin1 by column and
    lin2 by row, the hidden dropout the rank's columns of the whole mask."""
    if grid is None or grid.model_size <= 1:
        return lin2(dropout(torch.relu(lin1(x)), dp, gen))
    hid = torch.relu(lin1(copy_to_model(x, grid)))
    cols = hid.shape[-1]
    mine = (..., slice(grid.model_rank * cols, (grid.model_rank + 1) * cols))
    hid = dropout(hid, dp, gen, share=((*hid.shape[:-1], cols * grid.model_size), mine))
    return row_linear(hid, lin2, grid)


def av_han_layer(p: AVHanLayer, src_q: torch.Tensor, src_v: torch.Tensor, *, nhead: int,
                 dp: float, generator: torch.Generator | None = None,
                 grid=None) -> torch.Tensor:
    """The block (ref src/models/tspm.py:35-47): src_q + cross + self, norm1,
    the FFN, norm2."""
    crs, _ = mha(p.cm_attn, src_q, src_v, src_v, num_heads=nhead, need_weights=False,
                 dropout_p=dp, generator=generator, grid=grid)
    slf, _ = mha(p.self_attn, src_q, src_q, src_q, num_heads=nhead, need_weights=False,
                 dropout_p=dp, generator=generator, grid=grid)
    x = src_q + dropout(crs, dp, generator) + dropout(slf, dp, generator)
    x = p.norm1(x)
    x = x + dropout(_ffn(x, p.linear1, p.linear2, dp, generator, grid), dp, generator)
    return p.norm2(x)


def attn_ffn(p: AttnFFN, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, *,
             nhead: int, dp: float, generator: torch.Generator | None = None,
             need_weights: bool = False, grid=None):
    """query [B, Sq, D] -> (out [B, Sq, D], head-averaged weights [B, Sq, Sk]
    or None): the JAX ``_attn_ffn``."""
    attn, weights = mha(p.attn_qst_query, query, key, value, num_heads=nhead,
                        need_weights=need_weights, dropout_p=dp, generator=generator, grid=grid)
    src = dropout(_ffn(attn, p.qst_query_linear1, p.qst_query_linear2, dp, generator), dp,
                  generator)
    return p.qst_query_visual_norm(attn + src), weights


def topk_time_indices(temp_weights: torch.Tensor, k: int) -> torch.Tensor:
    """[B, 1, T] weights -> the K frames of largest weight, in time order
    [B, K]: a stable ascending argsort, its last K, sorted (the JAX
    ``topk_time_indices``; ``torch.topk`` breaks ties otherwise)."""
    order = torch.argsort(temp_weights[:, 0, :], dim=-1, stable=True)
    return torch.sort(order[:, -k:], dim=-1).values


def _take_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...] at the frames idx [B, K] -> [B, K, ...]
    (``take_along_axis`` along axis 1)."""
    shape = idx.shape + x.shape[2:]
    index = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, index)


def temporal_weights(p: AttnFFN, visual: torch.Tensor, qst_prompt: torch.Tensor, *,
                     dp: float, generator=None, grid=None) -> torch.Tensor:
    """The prompt-as-query attention's head-averaged weights over the frames
    [B, 1, T]. The JAX ``temporal_perception`` runs the whole ``_attn_ffn``
    and uses only these weights; its output is dead code, left out here."""
    _, weights = mha(p.attn_qst_query, qst_prompt[:, None, :], visual, visual, num_heads=ATTN_FFN_HEADS,
                     need_weights=True, dropout_p=dp, generator=generator, grid=grid)
    return weights


def temporal_perception(p: AttnFFN, audio: torch.Tensor, visual: torch.Tensor,
                        qst_prompt: torch.Tensor, *, topK: int, dp: float,
                        generator=None, grid=None):
    """(audio [B, K, D], visual [B, K, D], indices [B, K]) of the top-K
    frames (ref TemporalPerception, src/models/tspm.py:77-143), and the
    weights [B, 1, T] they were taken from."""
    weights = temporal_weights(p, visual, qst_prompt, dp=dp, generator=generator, grid=grid)
    idx = topk_time_indices(weights, topK)
    return _take_frames(audio, idx), _take_frames(visual, idx), idx, weights


def tokens_self_attn(p: TokensSelfAttn, x: torch.Tensor, *, nhead: int, dp: float,
                     generator=None, grid=None) -> torch.Tensor:
    """The patch-token block (ref TokensSelfAttn, 189-222)."""
    slf, _ = mha(p.self_attn, x, x, x, num_heads=nhead, need_weights=False, dropout_p=dp,
                 generator=generator, grid=grid)
    x = p.norm1(x + dropout(slf, dp, generator))
    x = x + dropout(_ffn(x, p.linear1, p.linear2, dp, generator, grid), dp, generator)
    return p.norm2(x)


def spatio_perception(p: SpatioPerception, audio_topk: torch.Tensor, patch: torch.Tensor,
                      topk_idx: torch.Tensor | None, *, dp: float,
                      generator=None, grid=None) -> torch.Tensor:
    """The selected frames' patches [B, K, N, C] under their own audio as
    the query -> [B, K, C] (ref SpatioPerceptionModule, 225-306)."""
    if topk_idx is not None:
        patch = _take_frames(patch, topk_idx)
    B, K, N, C = patch.shape
    patch_bt = tokens_self_attn(p.TokensAttn, patch.reshape(B * K, N, C), nhead=1, dp=dp,
                                generator=generator, grid=grid)
    out, _ = attn_ffn(p, audio_topk.reshape(B * K, 1, C), patch_bt, patch_bt, nhead=ATTN_FFN_HEADS, dp=dp,
                      generator=generator, grid=grid)
    return out.reshape(B, K, C)


def qst_temporal_grounding(p: AttnFFN, qst: torch.Tensor, audio: torch.Tensor,
                           visual: torch.Tensor, *, dp: float, generator=None, grid=None):
    """The question as the query over each stream, one parameter set for
    both (ref 146-186) -> (audio [B, D], visual [B, D])."""
    a, _ = attn_ffn(p, qst[:, None, :], audio, audio, nhead=ATTN_FFN_HEADS, dp=dp, generator=generator,
                    grid=grid)
    v, _ = attn_ffn(p, qst[:, None, :], visual, visual, nhead=ATTN_FFN_HEADS, dp=dp, generator=generator,
                    grid=grid)
    return a[:, 0], v[:, 0]


class TSPM(nn.Module):
    """Parameters named as the JAX pytree flattened, initialised on the CPU
    from ``seed`` with the JAX package's init statistics (the numbers
    differ: the generators differ)."""

    FROZEN_PREFIXES = TSPM_FROZEN_PREFIXES
    SITES = SITES

    def __init__(self, cfg: dict, seed: int = 0):
        super().__init__()
        self.cfg = dict(cfg)
        g = torch.Generator().manual_seed(seed)
        h = cfg["hidden_size"]
        self.input_a = _linear(cfg["audio_dim"], h, g)
        self.input_v = _linear(cfg["vis_dim"], h, g)
        self.input_v_patch = _linear(cfg["patch_dim"], h, g)
        self.input_qst = _linear(cfg["qst_dim"], h, g)
        self.input_qst_prompt = _linear(cfg["qst_dim"], h, g)
        self.AV_Attn = AVAttn(h, g)
        self.TemporalPerception = AttnFFN(h, g)
        self.SpatioPerception = SpatioPerception(h, g)
        self.QstTempGrd_Module = AttnFFN(h, g)
        self.av_fusion_fc = _linear(6 * h, h, g)
        self.answer_pred_fc = _linear(h, cfg["num_labels"], g)

    def check_model_parallel(self, tp: int) -> None:
        """Raise ``ValueError`` unless every split of this config divides by
        ``tp``: the hidden width (the one-head attentions' lanes and the
        FFNs' width, which equals it) and the AttnFFN attentions' heads."""
        dims = {"hidden_size": self.cfg["hidden_size"], "the attn_ffn heads": ATTN_FFN_HEADS}
        bad = {k: v for k, v in dims.items() if v % tp}
        if bad:
            raise ValueError(f"model_parallel={tp} does not divide {bad}")

    def forward(self, batch: dict, *, train: bool = False,
                generator: torch.Generator | None = None, sites: list | None = None,
                aux: bool = False, grid=None) -> dict:
        """batch: quest and prompt [B, Dq] or [B, 1, Dq] features, audio
        [B, T, audio_dim], video [B, T, vis_dim], patch [B, T, P, patch_dim]
        -> {'out': logits [B, num_labels]}, with ``aux`` also the temporal
        weights [B, 1, T] and the top-K frames [B, K].

        Dropout is active when ``train`` and a ``generator`` are given; its
        SITES sites draw from sub-generators seeded from ``generator``
        (``split_generator``), or from ``sites`` given ready seeded (the
        train step's CUDA graph). ``grid``: this rank's place in a data x
        model grid, the model holding its shards."""
        cfg = self.cfg
        dp, topK = cfg["dropout"], cfg["topK"]
        question, prompt = batch["quest"], batch["prompt"]
        if not torch.is_floating_point(question):
            raise NotImplementedError(TOKEN_IDS_REFUSED)
        if question.dim() == 3:
            question = question[:, 0]
        if prompt.dim() == 3:
            prompt = prompt[:, 0]
        if train and sites is not None:
            gens = sites
        elif train and generator is not None:
            gens = split_generator(generator, SITES, batch["audio"].device)
        else:
            gens = [None] * SITES

        audio = self.input_a(batch["audio"])
        visual = self.input_v(batch["video"])
        patch = self.input_v_patch(batch["patch"])
        qst = self.input_qst(question)
        qst_prompt = self.input_qst_prompt(prompt)

        B = audio.shape[0]
        both = av_han_layer(self.AV_Attn.layers["0"], torch.cat([audio, visual]),
                            torch.cat([visual, audio]), nhead=1, dp=dp, generator=gens[0],
                            grid=grid)
        audio_avattn, visual_avattn = both[:B], both[B:]

        audio_tssm, visual_tssm, idx, weights = temporal_perception(
            self.TemporalPerception, audio, visual, qst_prompt, topK=topK, dp=dp,
            generator=gens[1], grid=grid)
        visual_sp = spatio_perception(self.SpatioPerception, audio_tssm, patch, idx, dp=dp,
                                      generator=gens[2], grid=grid)
        audio_qtgm, visual_qtgm = qst_temporal_grounding(
            self.QstTempGrd_Module, qst, audio_tssm, visual_sp, dp=dp, generator=gens[3],
            grid=grid)

        av = torch.cat([audio_qtgm, audio_avattn.mean(-2), audio_tssm.mean(-2),
                        visual_qtgm, visual_avattn.mean(-2), visual_sp.mean(-2)], dim=-1)
        av = self.av_fusion_fc(torch.tanh(av))
        out = {"out": self.answer_pred_fc(torch.tanh(av * qst))}
        if aux:
            out.update(temporal_weights=weights, topk_idx=idx)
        return out
