"""The QA-TIGER network, PyTorch edition.

Port of ``qa_tiger_tpu/models/qa_tiger.py``: five input projections ->
question-guided AV cross attention -> patch selection -> audio and visual
temporal Gaussian MoE aggregation -> two stacked question groundings ->
ReLU -> Linear head. The frozen CLIP text tower encodes token ids online,
under ``torch.no_grad()`` (JAX: ``stop_gradient``), in its own dtype.

Under a ``grid`` of model size tp > 1 (``parallel/tensor.py``) the eval
and the train forward run each module's tensor-parallel form on the rank's
shards (``parallel.shard_module_``); projections, norms, embeddings and the
head stay whole. Every model rank of a data rank draws the same dropout
stream, and each module takes its share of the whole realization.
``check_model_parallel`` says whether a config splits.
"""
from __future__ import annotations

import torch
from torch import nn

from qa_tiger_tpu_torch.models import modules as M
from qa_tiger_tpu_torch.models.clip_text import CLIPTextTower
from qa_tiger_tpu_torch.nn.core import Linear

FROZEN_PREFIXES = ("quest_encoder",)
# the dropout sites of one forward, each with its own generator
SITES = 6


def check_text_ctx(quest, ctx: int | None) -> None:
    """Raise ``ValueError`` when ``ctx`` is set and a row of token ids
    ``quest`` (numpy or a tensor, [N, L]) has its EOT (the largest id) at or
    past it: the ``text_ctx`` trim would pool at a wrong position. Float
    questions (cached features) pass."""
    if not ctx or quest is None:
        return
    quest = torch.as_tensor(quest)
    if torch.is_floating_point(quest):
        return
    eot = quest.argmax(-1)
    if bool((eot >= ctx).any()):
        raise ValueError(
            f"text_ctx={ctx} but a question's EOT sits at position "
            f"{int(eot.max())}; raise text_ctx (tokenized questions "
            "must fit, including SOT/EOT)")


def qa_tiger_config(d_model: int = 512, video_dim: int = 512,
                    patch_dim: int = 768, audio_dim: int = 128,
                    topK: int = 3, num_experts: int = 10,
                    num_labels: int = 42,
                    encoder_type: str = "ViT-L/14@336px",
                    late_fusion: bool = False, nce_loss: bool = False,
                    gather_mode: str = "reference",
                    text_ctx: int | None = None,
                    encoder_dtype: str | None = None,
                    **_unused) -> dict:
    """Model hyperparameters, the JAX package's defaults; the shipped config
    (configs/qa-tiger/vitl14.py) sets d_model 512, video 768, patch 1024,
    audio 128, topK 7, experts 7."""
    return dict(
        d_model=d_model, video_dim=video_dim, patch_dim=patch_dim,
        audio_dim=audio_dim, topK=topK, num_experts=num_experts,
        num_labels=num_labels, encoder_type=encoder_type,
        nhead=8, sigma=9.0, dropout=0.1, gather_mode=gather_mode,
        text_ctx=text_ctx, encoder_dtype=encoder_dtype,
    )


class QATiger(nn.Module):
    """Parameters named as the JAX pytree flattened (``audio_proj.proj.weight``,
    ``crs_attn.qst_attn.in_proj_weight``, ``at_aggregator.experts.0.0.weight``,
    ``quest_encoder.transformer.resblocks.3.ln_1.bias``, ``head.weight``).
    Initialised on the CPU from ``seed`` with the JAX package's init
    statistics (the numbers differ: the generators differ)."""

    FROZEN_PREFIXES = FROZEN_PREFIXES
    SITES = SITES

    def __init__(self, cfg: dict, seed: int = 0):
        super().__init__()
        self.cfg = dict(cfg)
        g = torch.Generator().manual_seed(seed)
        d = cfg["d_model"]
        self.audio_proj = M.Projection(cfg["audio_dim"], d, g)
        self.video_proj = M.Projection(cfg["video_dim"], d, g)
        self.patch_proj = M.Projection(cfg["patch_dim"], d, g)
        # the words/quest projections take the CLIP text width, which equals
        # video_dim for the shipped ViT-L/14 tower
        self.words_proj = M.Projection(cfg["video_dim"], d, g)
        self.quest_proj = M.Projection(cfg["video_dim"], d, g)
        self.crs_attn = M.AVQCrossAttn(d, g)
        self.patch_selecter = M.PatchSelecter(d, g)
        self.quest_grounding = M.QstGrounding(d, g)
        self.at_aggregator = M.TempMoE(d, cfg["num_experts"], g, vis_branch=False)
        self.vt_aggregator = M.TempMoE(d, cfg["num_experts"], g, vis_branch=True)
        self.head = Linear(d, cfg["num_labels"], g)
        self.quest_encoder = CLIPTextTower(cfg["encoder_type"], g)

    def check_model_parallel(self, tp: int) -> None:
        """Raise ``ValueError`` unless every split of this config divides
        by ``tp``: heads (AVQ, the tower), d_model, its MLP halves, the
        tower's width and its MLP."""
        cfg, tower = self.cfg, self.quest_encoder.cfg
        dims = {"nhead": cfg["nhead"], "d_model": cfg["d_model"],
                "d_model // 2": cfg["d_model"] // 2, "text heads": tower["heads"],
                "text width": tower["width"]}
        bad = {k: v for k, v in dims.items() if v % tp}
        if bad:
            raise ValueError(f"model_parallel={tp} does not divide {bad}")

    def encode_question(self, quest: torch.Tensor,
                        words: torch.Tensor | None = None, grid=None):
        """(quest [B, Dq], words [B, L, W] or None) from one of three forms:

        - integer token ids [B, L] -> the frozen CLIP text tower, after the
          opt-in ``text_ctx`` trim; its outputs are cast to the dtype of the
          trainable projections, as the tower may run at another precision;
        - a float question [B, Dq] or [B, 1, Dq] with cached ``words``
          (the question cache's frozen-tower output), cast the same way;
        - a float question alone, which leaves ``words`` None.
        """
        tgt = self.quest_proj.proj.weight.dtype
        if not torch.is_floating_point(quest):
            ctx = self.cfg.get("text_ctx")
            if ctx and ctx < quest.shape[1]:
                quest = quest[:, :ctx]
            with torch.no_grad():
                pooled, words = self.quest_encoder(quest, grid=grid)
            return pooled.to(tgt), words.to(tgt)
        if quest.dim() == 3:
            quest = quest[:, 0]
        if words is not None:
            return quest.to(tgt), words.to(tgt)
        return quest, None

    def forward(self, batch: dict, *, train: bool = False,
                generator: torch.Generator | None = None,
                sites: list | None = None, grid=None) -> dict:
        """batch: quest [B, 77] token ids (or a float question, with
        ``quest_words``), audio [B, T, audio_dim], video [B, T, video_dim],
        patch [B, T, P, patch_dim] -> {'out': logits [B, num_labels]}.

        Dropout is active when ``train`` and a ``generator`` are given (JAX:
        ``train=True`` with a key); its six sites draw from sub-generators
        on the activations' device seeded from ``generator``
        (``split_generator``). ``sites`` gives those six generators ready
        seeded instead (the train step's CUDA graph owns persistent ones and
        reseeds them before each replay). ``grid``: the tensor-parallel form
        on its model ranks, eval or train."""
        cfg = self.cfg
        nhead, dp = cfg["nhead"], cfg["dropout"]
        quest, words = self.encode_question(batch["quest"], batch.get("quest_words"), grid)
        if words is None:
            raise ValueError("the words projection needs word features: pass "
                             "token ids, or a float question with quest_words")
        audio = self.audio_proj(batch["audio"])
        video = self.video_proj(batch["video"])
        patch = self.patch_proj(batch["patch"])
        words = self.words_proj(words)
        quest = self.quest_proj(quest)
        if train and sites is not None:
            gens = sites
        elif train and generator is not None:
            gens = split_generator(generator, SITES, audio.device)
        else:
            gens = [None] * SITES

        audio, video = self.crs_attn(audio, video, words, nhead=nhead, dropout_p=dp,
                                     generator=gens[0], grid=grid)
        patch_pair = self.patch_selecter(patch, audio, video, nhead=nhead, dropout_p=dp,
                                         generator=gens[1], grid=grid)
        moe = dict(nhead=nhead, topK=cfg["topK"], sigma=cfg["sigma"],
                   gather_mode=cfg["gather_mode"], grid=grid)
        a_global = self.at_aggregator(quest, audio, None, generator=gens[2], **moe)
        ap_global, vp_global = self.vt_aggregator(quest, video, patch_pair, generator=gens[3],
                                                  **moe)
        fusion = self.quest_grounding(quest, [ap_global, vp_global], nhead=nhead,
                                      dropout_p=dp, generator=gens[4], grid=grid)
        fusion = self.quest_grounding(quest, [fusion[:, None, :], a_global], nhead=nhead,
                                      dropout_p=dp, generator=gens[5], grid=grid)
        return {"out": self.head(torch.relu(fusion))}


def split_seeds(generator: torch.Generator, n: int) -> list[int]:
    """The n seeds ``split_generator`` draws from ``generator``, in order.
    They are read on the host, so a host generator costs no wait for the
    card (a CUDA one does)."""
    seeds = torch.randint(0, 2 ** 62, (n,), generator=generator, device=generator.device)
    return [int(s) for s in seeds.tolist()]


def split_generator(generator: torch.Generator, n: int, device) -> list:
    """n generators on ``device``, seeded from ``generator``: a deterministic
    split of one dropout stream into one per site."""
    return [torch.Generator(device=device).manual_seed(s) for s in split_seeds(generator, n)]
