from qa_tiger_tpu_torch.nn.attention import MultiheadAttention, mha
from qa_tiger_tpu_torch.nn.core import (
    MLP2,
    LayerNorm,
    Linear,
    dropout,
    layer_norm,
    linear,
    mlp2,
    quick_gelu,
)

__all__ = [
    "MLP2",
    "LayerNorm",
    "Linear",
    "dropout",
    "MultiheadAttention",
    "layer_norm",
    "linear",
    "mha",
    "mlp2",
    "quick_gelu",
]
