"""qa_tiger_tpu_torch — QA-TIGER serving, training and raw-media inference
in PyTorch for an NVIDIA H100, with hand-written CUDA kernels for the hot
operations.

It mirrors the layout of the JAX package ``qa_tiger_tpu`` so that every
module has an obvious counterpart there, and it imports nothing from it:

- ``nn``:       Linear / LayerNorm / torch-semantics multi-head attention and
                dropout; ``state_dict`` names equal the JAX parameter
                pytree's flattened names.
- ``ops``:      the kernels (``attention_wide`` with its ToMe key bias,
                ``fused_attn_ln2``, ``fused_gaussian_moe``,
                ``fused_patch_select``, and the train pairs
                ``fused_avq_train``, ``fused_patch_select_train``), each
                beside its plain PyTorch version and differentiable; the
                TempMoE routing math, ToMe merging, the log-mel frontend.
- ``models``:   the CLIP text and image towers, the ToMe ViT, the QA-TIGER
                blocks (eval and train paths, dropout-mask samplers) and
                network, ``build_model``.
- ``pipeline``: VGGish, the raw-media forward (``e2e``), the offline
                extraction stages (``extract``) and feature shards
                (``consolidate``).
- ``training``: metrics, Adam and the LR schedules, checkpoints,
                ``AVQARunner``.
- ``data``:     annotations, the CLIP tokenizer, QA prompts, the feature
                dataset, its batch loader and the native .npy reader.
- ``convert``:  JAX parameter pytrees and ``best.npz`` dicts -> state_dict,
                torch ``.pt`` files both ways, CLIP checkpoints.
- ``utils``:    configs and command-line overrides, seeding, run logging.
- ``predict``:  ``Predictor``, the batch serving entry point.
- ``train``, ``test``: ``python -m qa_tiger_tpu_torch.train|test``.

A CUDA tensor goes through the kernels (built from ``csrc/`` at first use);
a CPU tensor goes through the plain versions. Importing the package builds
nothing.
"""

__version__ = "0.3.0"
