"""The CLIP ModifiedResNet image tower (the RN family), PyTorch edition.

Port of ``qa_tiger_tpu/models/clip_resnet.py`` (the reference's vendored
OpenAI CLIP ModifiedResNet, src/models/base/clip_base.py:10-154): a 3-conv
stem with an average pool, four Bottleneck stages in which every strided
convolution is an average pool followed by a stride-1 convolution, and a
QKV attention pool in place of global average pooling.

Parameter names are CLIP's ``visual.*`` names: ``conv1..3`` / ``bn1..3``,
``layerN.M.{conv,bn}{1,2,3}``, ``layerN.M.downsample.{0,1}`` and
``attnpool.{positional_embedding,q_proj,k_proj,v_proj,c_proj}``, so the
JAX parameter tree flattened (``convert.params_from_jax``) and a converted
CLIP checkpoint load with ``load_state_dict(strict=True)``. BatchNorm's
running statistics are buffers; a checkpoint's ``num_batches_tracked``
entries are dropped by ``models.clip.build_towers``.

Numerics follow the JAX package: eval-mode BatchNorm is a scale
``w * rsqrt(var + eps)`` and a shift ``b - mean * scale``, computed in the
parameters' dtype and cast to the activations' before ``x * scale +
shift`` (neither ``F.batch_norm`` nor folding it into the convolution
rounds there). The convolutions are ``F.conv2d`` (cuDNN on the card), as
the JAX package runs them through XLA, not Pallas. Images come in NHWC; the
NCHW view of them is channels-last in memory.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from qa_tiger_tpu_torch.nn.core import Linear, linear

BN_EPS = 1e-5
EXPANSION = 4  # Bottleneck.expansion (clip_base.py:11)

# OpenAI's released RN image towers; embed_dim = width * 32, heads =
# embed_dim // 64 (the reference's build_model, clip_base.py:473-499)
CLIP_RESNET_CONFIGS: dict[str, dict] = {
    "RN50": dict(layers=(3, 4, 6, 3), width=64, output_dim=1024, input_resolution=224),
    "RN101": dict(layers=(3, 4, 23, 3), width=64, output_dim=512, input_resolution=224),
    "RN50x4": dict(layers=(4, 6, 10, 6), width=80, output_dim=640, input_resolution=288),
}


def resnet_config(name: str) -> dict:
    if name not in CLIP_RESNET_CONFIGS:
        raise KeyError(f"unknown CLIP ResNet type {name!r}; "
                       f"known: {sorted(CLIP_RESNET_CONFIGS)}")
    cfg = dict(CLIP_RESNET_CONFIGS[name])
    cfg["embed_dim"] = cfg["width"] * 32
    cfg["heads"] = cfg["embed_dim"] // 64
    return cfg


class Conv(nn.Module):
    """``weight`` [out, in, k, k], no bias; torch Conv2d's default init,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""

    def __init__(self, out_ch: int, in_ch: int, k: int, generator: torch.Generator):
        super().__init__()
        bound = (in_ch * k * k) ** -0.5
        self.weight = nn.Parameter(
            (torch.rand(out_ch, in_ch, k, k, generator=generator) * 2 - 1) * bound)

    def forward(self, x: torch.Tensor, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), stride=stride, padding=padding)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm as a scale and a shift (see the module's
    docstring); ``running_mean`` and ``running_var`` are buffers."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int, generator: torch.Generator):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = Conv(planes, inplanes, 1, generator), BatchNorm(planes)
        self.conv2, self.bn2 = Conv(planes, planes, 3, generator), BatchNorm(planes)
        self.conv3 = Conv(planes * EXPANSION, planes, 1, generator)
        self.bn3 = BatchNorm(planes * EXPANSION)
        if stride > 1 or inplanes != planes * EXPANSION:
            # avgpool -> 1x1 conv ("0") -> bn ("1"), the reference's names
            self.downsample = nn.ModuleDict({
                "0": Conv(planes * EXPANSION, inplanes, 1, generator),
                "1": BatchNorm(planes * EXPANSION)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out, padding=1)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        identity = x
        if hasattr(self, "downsample"):
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample["1"](self.downsample["0"](identity))
        return torch.relu(out + identity)


class AttentionPool(nn.Module):
    """The QKV attention pool (clip_base.py:58-95)."""

    def __init__(self, spacial: int, embed: int, out_d: int, generator: torch.Generator):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(spacial ** 2 + 1, embed, generator=generator) / embed ** 0.5)
        self.q_proj = Linear(embed, embed, generator, init="torch")
        self.k_proj = Linear(embed, embed, generator, init="torch")
        self.v_proj = Linear(embed, embed, generator, init="torch")
        self.c_proj = Linear(embed, out_d, generator, init="torch")

    def forward(self, tokens: torch.Tensor, heads: int) -> torch.Tensor:
        """[B, H*W, C] -> [B, output_dim]: the mean token prepended, the
        positional embedding added, one query (the mean token's) over all
        tokens; q * hd^-0.5 rounds in the activation dtype, the logits and
        softmax are fp32 and cast back, then c_proj."""
        B, _, C = tokens.shape
        dt = tokens.dtype
        x = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        x = x + self.positional_embedding.to(dt)

        def proj(lin, v):
            return linear(v, lin.weight.to(dt), lin.bias.to(dt))

        hd = C // heads
        q = proj(self.q_proj, x[:, :1]).reshape(B, 1, heads, hd)
        k = proj(self.k_proj, x).reshape(B, -1, heads, hd)
        v = proj(self.v_proj, x).reshape(B, -1, heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", (q * hd ** -0.5).float(), k.float())
        attn = torch.softmax(attn, dim=-1).to(dt)
        pooled = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, 1, C)
        return proj(self.c_proj, pooled)[:, 0]


class CLIPResNetTower(nn.Module):
    """CLIP's RN ``visual`` parameters (``clip_resnet_encode`` runs them);
    weights from ``seed`` with the JAX package's init statistics
    (``clip_resnet_init``: BatchNorm at weight 1, bias 0, mean 0, var 1)."""

    def __init__(self, name: str = "RN50", seed: int = 0):
        super().__init__()
        cfg = resnet_config(name)
        self.name, self.cfg = name, cfg
        g = torch.Generator().manual_seed(seed)
        w = cfg["width"]
        self.conv1, self.bn1 = Conv(w // 2, 3, 3, g), BatchNorm(w // 2)
        self.conv2, self.bn2 = Conv(w // 2, w // 2, 3, g), BatchNorm(w // 2)
        self.conv3, self.bn3 = Conv(w, w // 2, 3, g), BatchNorm(w)
        inplanes = w
        for i, (planes, blocks) in enumerate(zip((w, 2 * w, 4 * w, 8 * w), cfg["layers"]),
                                             start=1):
            layer = nn.ModuleList([Bottleneck(inplanes, planes, 1 if i == 1 else 2, g)])
            inplanes = planes * EXPANSION
            layer.extend(Bottleneck(inplanes, planes, 1, g) for _ in range(1, blocks))
            setattr(self, f"layer{i}", layer)
        self.attnpool = AttentionPool(cfg["input_resolution"] // 32, cfg["embed_dim"],
                                      cfg["output_dim"], g)


def clip_resnet_encode(model: CLIPResNetTower, images: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] CLIP-normalised images (NHWC) -> (pooled [B,
    output_dim], the pre-pool tokens [B, (H/32)*(W/32), embed_dim],
    row-major over the grid)."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(model.bn1(model.conv1(x, stride=2, padding=1)))
    x = torch.relu(model.bn2(model.conv2(x, padding=1)))
    x = torch.relu(model.bn3(model.conv3(x, padding=1)))
    x = F.avg_pool2d(x, 2)
    for i in range(1, 5):
        for block in getattr(model, f"layer{i}"):
            x = block(x)
    tokens = x.flatten(2).transpose(1, 2)
    return model.attnpool(tokens, model.cfg["heads"]), tokens
