"""qa_tiger_tpu_torch — the QA-TIGER eval/serving forward in PyTorch for an
NVIDIA H100, with hand-written CUDA kernels for the hot operations.

It mirrors the layout of the JAX package ``qa_tiger_tpu`` so that every
module has an obvious counterpart there, and it imports nothing from it:

- ``nn``:      Linear / LayerNorm / torch-semantics multi-head attention as
               ``nn.Module``s whose ``state_dict`` names equal the JAX
               parameter pytree's flattened names.
- ``ops``:     the four kernels of the eval path (``attention_wide``,
               ``fused_attn_ln2``, ``fused_gaussian_moe``,
               ``fused_patch_select``), each beside its plain PyTorch
               version, and the TempMoE routing math.
- ``models``:  the CLIP text tower, the QA-TIGER blocks and network, and
               ``build_model``.
- ``convert``: JAX parameter pytrees and ``best.npz`` dicts -> state_dict.
- ``predict``: ``Predictor``, the batch serving entry point.

A CUDA tensor goes through the kernels (built from ``csrc/`` at first use);
a CPU tensor goes through the plain versions. Importing the package builds
nothing.
"""

__version__ = "0.1.0"
