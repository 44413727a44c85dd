"""Operations of the eval and train paths: the CUDA kernels with their plain
PyTorch versions, and the TempMoE routing math.

``KERNELS`` lists every kernel wrapper; each carries an integer
``launches`` counter that it bumps only when it launches its kernel. The
train kernels' backward launchers (``*_bwd``) are listed beside them: they
run under autograd, from the ``torch.autograd.Function`` of their forward.
``attention_wide_key_bias`` counts the key-bias launches of
``attention_wide`` (ToMe), which ``attention_wide`` counts as well.
``fused_attn_half`` counts every attention-half launch, those that
``fused_resblock`` makes included; ``fused_resblock`` counts its MLP-half
launches. ``gemm_route`` names the GEMM routine (``gemm_sm90`` or
``gemm_tile``) a fused kernel's product takes on the card;
``fused_attn_ln2``, ``fused_attn_half``, ``fused_resblock`` (its MLP half's
two) and ``fused_patch_select`` tally the route of each product they launch
in ``gemm_routes``; the two train kernels' forwards and backwards tally the
routine each of their products reported as it launched (``gemm_tf32x3`` in
fp32; in bf16 ``gemm_sm90`` for the forwards, ``gemm_tile``'s WMMA loop for
the backwards); ``fused_gaussian_moe`` tallies its two products' (its own
``wgmma`` kernel or 3xTF32 for the first, ``gemm_tf32x3`` for the second).
"""
from qa_tiger_tpu_torch.ops.attention import (
    attention_wide,
    attention_wide_key_bias,
    fused_attention,
)
from qa_tiger_tpu_torch.ops.avq import fused_avq_train, fused_avq_train_bwd
from qa_tiger_tpu_torch.ops.gaussian_moe import fused_gaussian_moe
from qa_tiger_tpu_torch.ops.gemm import gemm_route
from qa_tiger_tpu_torch.ops.patch_select import (
    fused_patch_select,
    fused_patch_select_train,
    fused_patch_select_train_bwd,
)
from qa_tiger_tpu_torch.ops.resblock import fused_attn_half, fused_attn_ln2, fused_resblock

KERNELS = {
    "fused_attn_ln2": fused_attn_ln2,
    "attention_wide": attention_wide,
    "attention_wide_key_bias": attention_wide_key_bias,
    "fused_patch_select": fused_patch_select,
    "fused_gaussian_moe": fused_gaussian_moe,
    "fused_avq_train": fused_avq_train,
    "fused_avq_train_bwd": fused_avq_train_bwd,
    "fused_patch_select_train": fused_patch_select_train,
    "fused_patch_select_train_bwd": fused_patch_select_train_bwd,
    "fused_attention": fused_attention,
    "fused_attn_half": fused_attn_half,
    "fused_resblock": fused_resblock,
}


def reset_launches() -> None:
    """Sets every ``launches`` counter to 0 and clears the ``gemm_routes``
    tallies of the kernels that keep one."""
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "gemm_routes"):
            fn.gemm_routes = {}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "attention_wide", "attention_wide_key_bias", "fused_attention",
           "fused_attn_half", "fused_attn_ln2", "fused_avq_train", "fused_avq_train_bwd",
           "fused_gaussian_moe", "fused_patch_select", "fused_patch_select_train",
           "fused_patch_select_train_bwd", "fused_resblock", "gemm_route", "launch_counts",
           "reset_launches"]
