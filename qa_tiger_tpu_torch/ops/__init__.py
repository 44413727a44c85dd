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
The two train kernels' forwards and backwards, and their TP stages that run
attention, also tally the kernel of each keep-masked attention they launch
in ``attn_routes`` ("mma_keep" on tensor cores, else an FMA kernel's name),
as the launcher reported it in the launch's attention rows
(``ops.attention.keep_rows``), each time their wrappers run, a graph capture
included: ``launch_state`` and the replays leave it alone.

``TP_STAGES`` lists the stages of the tensor-parallel forms
(``parallel/tensor.py``), eval and train, each with its own ``launches``
counter; a stage that launches a kernel's TP form also counts one launch of
that kernel (``fused_attn_ln2_partial``, ``fused_patch_select_tp_self``,
``fused_gaussian_moe_partial``, ``attention_wide_tp_scores`` (the first of
one-head attention's two stages split by lanes); the train kernels' first
forward and first backward stages, ``fused_avq_train_tp_attn``,
``fused_avq_train_bwd_tp_ffn``, ``fused_patch_select_train_tp_self`` and
``fused_patch_select_train_bwd_tp_mlp``), so a rank's ``launch_counts``
equal a single process's. The train stages tally their products' routes in
their own ``gemm_routes``. ``reset_launches`` clears them too;
``stage_counts`` reads them.

A CUDA graph runs the wrappers' Python once, while it is captured, and
launches their kernels at every replay. So the graph's owner takes the
counters' difference across the capture (``launch_state`` before and after,
``launch_delta``), puts the counters back (``restore_launches``: a capture
launches nothing) and adds the difference once per replay
(``add_launches``).
"""
from qa_tiger_tpu_torch.ops.attention import (
    attention_wide,
    attention_wide_key_bias,
    attention_wide_tp_pv,
    attention_wide_tp_scores,
    fused_attention,
)
from qa_tiger_tpu_torch.ops.avq import TP_STAGES as AVQ_TP_STAGES
from qa_tiger_tpu_torch.ops.avq import fused_avq_train, fused_avq_train_bwd
from qa_tiger_tpu_torch.ops.gaussian_moe import fused_gaussian_moe, fused_gaussian_moe_partial
from qa_tiger_tpu_torch.ops.gemm import gemm_route
from qa_tiger_tpu_torch.ops.patch_select import TP_TRAIN_STAGES as PATCH_TP_TRAIN_STAGES
from qa_tiger_tpu_torch.ops.patch_select import (
    fused_patch_select,
    fused_patch_select_tp_cross,
    fused_patch_select_tp_cross_post,
    fused_patch_select_tp_mlp,
    fused_patch_select_tp_out,
    fused_patch_select_tp_self,
    fused_patch_select_tp_self_post,
    fused_patch_select_train,
    fused_patch_select_train_bwd,
)
from qa_tiger_tpu_torch.ops.resblock import (
    fused_attn_half,
    fused_attn_ln2,
    fused_attn_ln2_partial,
    fused_attn_ln2_post,
    fused_resblock,
)

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

TP_STAGES = {fn.__name__: fn for fn in (
    fused_attn_ln2_partial, fused_attn_ln2_post, fused_patch_select_tp_self,
    fused_patch_select_tp_self_post, fused_patch_select_tp_cross,
    fused_patch_select_tp_cross_post, fused_patch_select_tp_mlp, fused_patch_select_tp_out,
    fused_gaussian_moe_partial, attention_wide_tp_scores, attention_wide_tp_pv, *AVQ_TP_STAGES,
    *PATCH_TP_TRAIN_STAGES)}


def reset_launches() -> None:
    """Sets every ``launches`` counter to 0 and clears the ``gemm_routes``
    and ``attn_routes`` tallies of the kernels and stages that keep one."""
    for fn in [*KERNELS.values(), *TP_STAGES.values()]:
        fn.launches = 0
        for tally in ("gemm_routes", "attn_routes"):
            if hasattr(fn, tally):
                setattr(fn, tally, {})


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def stage_counts() -> dict:
    """The tensor-parallel stages' ``launches``, by name."""
    return {name: fn.launches for name, fn in TP_STAGES.items()}


def launch_state() -> dict:
    """Every kernel's (launches, gemm_routes copy) as they stand."""
    return {name: (fn.launches, dict(getattr(fn, "gemm_routes", {})))
            for name, fn in KERNELS.items()}


def restore_launches(state: dict) -> None:
    """Sets the counters and route tallies back to a ``launch_state``."""
    for name, (launches, routes) in state.items():
        KERNELS[name].launches = launches
        if hasattr(KERNELS[name], "gemm_routes"):
            KERNELS[name].gemm_routes = dict(routes)


def launch_delta(before: dict, after: dict) -> dict:
    """What ran between two ``launch_state``s: {name: (launches, routes)}
    for each kernel that launched."""
    delta = {}
    for name, (n, routes) in after.items():
        n0, routes0 = before[name]
        added = {r: c - routes0.get(r, 0) for r, c in routes.items() if c != routes0.get(r, 0)}
        if n != n0 or added:
            delta[name] = (n - n0, added)
    return delta


def add_launches(delta: dict) -> None:
    """Adds a ``launch_delta`` to the counters and route tallies: once per
    replay of the graph it was taken across."""
    for name, (n, routes) in delta.items():
        fn = KERNELS[name]
        fn.launches += n
        for route, count in routes.items():
            fn.gemm_routes[route] = fn.gemm_routes.get(route, 0) + count


__all__ = ["KERNELS", "TP_STAGES", "stage_counts", "attention_wide", "attention_wide_key_bias", "fused_attention",
           "fused_attn_half", "fused_attn_ln2", "fused_avq_train", "fused_avq_train_bwd",
           "fused_gaussian_moe", "fused_patch_select", "fused_patch_select_train",
           "fused_patch_select_train_bwd", "fused_resblock", "gemm_route", "add_launches",
           "launch_counts", "launch_delta", "launch_state", "reset_launches", "restore_launches"]
