"""Softmax attention: multi-head on dense heads-in-lanes [B, S, W] tensors
(``attention_wide``) and classic head-split [BH, S, dh] (``fused_attention``).

Port of ``qa_tiger_tpu/ops/pallas/attention.py``: ``attention_wide``, with
its optional per-(batch element, key) bias (ToMe's proportional attention),
and ``fused_attention``. The CUDA kernels in ``csrc/attention.cu`` run for
CUDA tensors, the plain versions for CPU tensors. On the card bf16 calls
without a keep mask take a tensor-core kernel: at head sizes 32, 64 and 128
the short one (a warp per problem) at most 16 queries and 16 keys, the mma
one at least 16 of each, except at head size 64 past 128 keys where the
measured rule ``sm90_faster`` holds, which take the Hopper kernel
("mma_sm90", route "wgmma", ``csrc/attention_sm90.cuh``: TMA and wgmma, the
CLIP image tower's 577 tokens and most of ToMe's long layers);
at 256 and 512 (and, zero-padded, any head between
128 and 512 lanes) the wide short one at most 16 of each, the wide mma one
at any other length whose probabilities fit its shared memory. A call
with a keep mask (the train kernels' dropout attentions, which reach the
kernels from ``csrc/avq.cu`` and ``csrc/patch_select_train.cu``) at head
sizes 32, 64 and 128 over at most 128 keys takes the keep-masked
tensor-core kernel in bf16 and fp32 ("mma_keep", ``csrc/attention_keep.cu``;
``attention_bwd_plan`` plans its backward). Every fp32 call without a keep
mask at those head sizes runs on 3xTF32 tensor cores, an additive mask and a
key bias included: up to 128 keys the same kernel with its keep multiply
compiled out ("mma_nokeep": the fp32 evaluation forward's attentions, the
fp32 text towers' causal calls), past 128 keys its key-tiled two-pass form
("mma_nokeep_tiled": the fp32 CLIP image tower's 577 keys, ToMe's long
key-bias layers); at head sizes 256 and 512 without a mask or key bias the
lane split's two stages at one rank, a head at a time ("lane_split":
TSPM's one-head calls in fp32), which score into a scratch [B, Sq, Sk] the
wrapper allocates. A bf16 call without a keep mask, a mask or a key bias
at 32-128 lanes over 17-128 keys with fewer than 16 queries (TempMoE's
1 x 60) takes "mma_nokeep" too, which no other tensor-core kernel covers.
Every other call takes an fp32 FMA kernel: whole keys staged in shared
memory up to 128 keys where they fit the block's opt-in shared memory, else
key tiles in two passes (64-key tiles at head sizes up to 128, the
wide-head kernel's 16 or 32-key tiles at 256 and 512). ``attention_plan``
says in Python which kernel a call takes, at which head size and with how
much shared memory, by the rule ``qt::attention_plan`` applies on the card
(``csrc/common.cuh``); ``attention_route`` asks the library for the route.
A call no kernel takes at its own head size is zero-padded to the next
size one takes; one that no size fits raises, naming its shape. A bf16
operand the tensor-core kernel cannot read with 16-byte copies (an fp32 one
on the 3xTF32 kernels) is copied to a contiguous tensor first; neither changes
the route. ``attention_wide.attn_routes`` tallies the kernel each launch
took, as the library reports it. On CUDA
the gradient is that of the plain version, recomputed (``ops/_grad.py``),
the JAX ``custom_vjp`` rules: q, k, v, ``key_bias`` and a mask that
requires grad get real cotangents.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from qa_tiger_tpu_torch.ops import _build, _grad

# the staged kernel takes at most this many keys (csrc/common.cuh,
# ATT_STAGED_MAX_SK); the tiled kernels take the head sizes below
STAGED_MAX_SK = 128
KERNEL_HEAD_SIZES = (32, 64, 128, 256, 512)
# bf16 without a keep mask: the head sizes of the tensor-core kernels; the
# wide ones stream the head in 64-lane slabs
TC_HEAD_SIZES = (32, 64, 128, 256, 512)
WIDE_HEAD_SIZES = (256, 512)
# qt_attention_route's codes (csrc/common.cuh, AttentionRoute)
ROUTES = ("fma", "mma", "mma_short", "mma_keep", "mma_nokeep", "tf32x3", "wgmma")
# qt_attention_plan's codes (csrc/common.cuh, AttentionKernel), from 0
KERNEL_NAMES = ("staged", "tiled", "wide", "mma", "mma_short", "mma_wide", "mma_wide_short",
                "mma_keep", "mma_nokeep", "mma_nokeep_tiled", "lane_split", "mma_sm90")
# each tensor-core kernel's route; every other kernel's is "fma"
KERNEL_ROUTES = {"mma": "mma", "mma_wide": "mma", "mma_short": "mma_short",
                 "mma_wide_short": "mma_short", "mma_keep": "mma_keep",
                 "mma_nokeep": "mma_nokeep", "mma_nokeep_tiled": "mma_nokeep",
                 "lane_split": "tf32x3", "mma_sm90": "wgmma"}
# the fp32 kernels that read their operands with 16-byte cp.async copies
# (every bf16 tensor-core kernel does)
FP32_TC_KERNELS = ("mma_nokeep", "mma_nokeep_tiled", "lane_split")
# a keep mask (the train kernels' dropout attentions), bf16 and fp32: the
# head sizes and the longest keys of the keep-masked tensor-core kernels
# (csrc/attention_keep.cu; ATT_KEEP_MAX_SK)
KEEP_HEAD_SIZES = (32, 64, 128)
KEEP_MAX_SK = 128
# an H100's opt-in shared memory per block, the plan's limit for a call on
# the CPU; on the card the device's own (qt_smem_optin)
H100_SMEM_OPTIN = 232_448
# the kernels' tiles (csrc/common.cuh): ATT_WARPS; AT_Q, AT_K; AW_Q; AM_Q,
# AM_K, AM_PAD; AS_WARPS, AS_ROWS; AWM_SLAB, AWM_STAGES; AKT_Q, AKT_K (the
# key-tiled fp32 kernel's query rows and key tile); ATT_LANES_SMEM
_ATT_WARPS, _AT_Q, _AT_K, _AW_Q = 4, 64, 64, 16
_AM_Q, _AM_K, _AM_PAD, _AS_WARPS, _AS_ROWS = 64, 64, 8, 4, 16
_AWM_SLAB, _AWM_STAGES = 64, 2
_AKT_Q, _AKT_K = 128, 64
LANE_SPLIT_SMEM = 2 * 128 * 144
# the Hopper kernel (csrc/common.cuh AS9_*, ATT_SM90_MIN_SK): bf16 at head
# size 64 over at least SM90_MIN_SK keys; 128 query rows and 128-key tiles,
# two Q buffers, SM90_KSTAGES K and SM90_VSTAGES V stages of 128 rows x 128
# bytes, each K stage's key bias, 20 barriers and 1 KB of alignment slack
SM90_HEAD, SM90_MIN_SK = 64, 129
_AS9_Q, _AS9_K, SM90_KSTAGES, SM90_VSTAGES = 128, 128, 5, 3
SM90_SMEM = (1024 + (2 * _AS9_Q + (SM90_KSTAGES + SM90_VSTAGES) * _AS9_K) * 128
             + SM90_KSTAGES * _AS9_K * 4 + 8 * (4 + 2 * SM90_KSTAGES + 2 * SM90_VSTAGES))
# the switch of qt_attention_sm90_mode, by index
SM90_MODES = ("default", "off", "always")


def sm90_faster(sk: int) -> bool:
    """The measured rule of ``qt::sm90_faster`` (csrc/common.cuh): the
    Hopper kernel's 128-key tiles beat attention_mma_kernel's 64-key ones
    past 3 tiles, and up to 3 where the last tile is more than half full or
    full (ToMe's layers, chip_smoke.py's ``sm90_sweep``)."""
    return sk > 3 * _AS9_K or sk % _AS9_K == 0 or sk % _AS9_K > _AS9_K // 2
# attention_wide's lane split (csrc/attention_tp.cuh, TP_SHORT): a problem of
# at most this many queries and keys is one warp's
TP_SHORT_MAX = 16


class AttentionPlan(NamedTuple):
    route: str       # one of ROUTES
    kernel: str      # one of KERNEL_NAMES
    head: int        # the head size the kernel runs at (zero-padded past hd)
    smem_bytes: int  # the kernel's dynamic shared memory per block


def _smem_bytes(kernel: str, sk: int, hd: int) -> int:
    """Each kernel's dynamic shared memory, as its launcher computes it."""
    if kernel == "staged":
        return 4 * (sk * (hd + 1) + sk * hd + _ATT_WARPS * (hd + sk))
    if kernel == "tiled":
        return 4 * ((_AT_Q + _AT_K) * (hd + 1) + _AT_K * hd + _AT_Q * (_AT_K + 1))
    if kernel == "wide":
        kt = 16 if hd >= 512 else 32
        return 4 * ((_AW_Q + kt) * (hd + 4) + kt * hd + _AW_Q * (kt + 1))
    if kernel == "mma":
        return 2 * (_AM_Q + 4 * _AM_K) * (hd + _AM_PAD)
    if kernel == "mma_nokeep_tiled":
        # the Q rows, two stages of K and two of V: rows of hd + 4 floats
        return 4 * (_AKT_Q + 4 * _AKT_K) * (hd + 4)
    if kernel == "lane_split":
        return LANE_SPLIT_SMEM
    if kernel == "mma_sm90":
        return SM90_SMEM
    slab_row = _AWM_SLAB + _AM_PAD
    if kernel == "mma_wide":
        # the ring of Q and K slabs (V chunks); in two passes (past 128
        # keys) also p: 64 rows of Sk rounded up to 16, padded
        p_bytes = _AM_Q * (-(-sk // 16) * 16 + _AM_PAD) if sk > 2 * _AM_K else 0
        return 2 * (_AWM_STAGES * (_AM_Q + _AM_K) * slab_row + p_bytes)
    if kernel == "mma_wide_short":
        return 2 * _AS_WARPS * _AWM_STAGES * 2 * _AS_ROWS * slab_row
    return 2 * _AS_WARPS * 2 * 3 * _AS_ROWS * (hd + _AM_PAD)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _keep_smem_bytes(bf16: bool, sq: int, sk: int, hd: int, backward: bool,
                     has_keep: bool = True) -> int:
    """The keep-masked kernels' dynamic shared memory per block
    (``attention_keep_smem_bytes`` / ``attention_keep_bwd_smem_bytes`` in
    csrc/common.cuh): rows of hd lanes plus 16 bytes; at most 16 queries and
    keys four warps a block, a problem each (q, k, v; backward also g, dS
    and pd); forward without a keep mask, at most 16 queries over more keys
    one warp a block, its 16 query rows and the problem's k and v
    (``keep_form`` AK_WARP), else 64 query rows with the problem's k and v;
    backward, the whole problem (its k and v at least 64 rows together:
    they stage the warps' dk and dv tiles)."""
    es = 2 if bf16 else 4
    ld = hd + 16 // es
    pld = _pad16(sk) + (8 if bf16 else 4)  # dS / pd rows
    short = sq <= _AS_ROWS and sk <= _AS_ROWS
    if not backward:
        if short:
            return es * _AS_WARPS * 3 * _AS_ROWS * ld
        rows = _AS_ROWS if sq <= _AS_ROWS and not has_keep else _AM_Q
        return es * (rows + 2 * _pad16(sk)) * ld
    if short:
        return es * _AS_WARPS * _AS_ROWS * (4 * ld + 2 * pld)
    kv_rows = max(2 * _pad16(sk), _AM_Q)  # k and v, later the warps' dk / dv tiles
    return es * ((2 * _pad16(sq) + kv_rows) * ld + 2 * _pad16(sq) * pld)


def _keep_kernel(bf16: bool, sq: int, sk: int, hd: int, backward: bool,
                 limit: int, has_keep: bool = True) -> int | None:
    """The keep-masked tensor-core kernel's shared memory where it takes a
    call (a head size of KEEP_HEAD_SIZES, at most KEEP_MAX_SK keys, within
    ``limit``), else None."""
    if hd not in KEEP_HEAD_SIZES or not 1 <= sk <= KEEP_MAX_SK:
        return None
    nbytes = _keep_smem_bytes(bf16, sq, sk, hd, backward, has_keep)
    return nbytes if nbytes <= limit else None


def _fp32_tc_kernel(sq: int, sk: int, hd: int, has_bias: bool, limit: int) -> tuple:
    """The 3xTF32 kernel of an fp32 call without a keep mask, with its
    shared memory, where one takes it within ``limit``: (kernel or None,
    bytes)."""
    if hd in KEEP_HEAD_SIZES and sk >= 1:
        kernel = "mma_nokeep" if sk <= KEEP_MAX_SK else "mma_nokeep_tiled"
        nbytes = (_keep_smem_bytes(False, sq, sk, hd, False, has_keep=False)
                  if kernel == "mma_nokeep" else _smem_bytes(kernel, sk, hd))
    elif hd in WIDE_HEAD_SIZES and sk >= 1 and not has_bias:
        kernel, nbytes = "lane_split", LANE_SPLIT_SMEM
    else:
        return None, 0
    return (kernel, nbytes) if nbytes <= limit else (None, 0)


def _kernel_at(bf16: bool, sq: int, sk: int, hd: int, has_keep: bool, has_bias: bool,
               limit: int) -> tuple[str | None, int]:
    """``qt::attention_plan`` at one head size: (kernel or None, bytes)."""
    wide = hd in WIDE_HEAD_SIZES
    if not bf16 and not has_keep:
        kernel, nbytes = _fp32_tc_kernel(sq, sk, hd, has_bias, limit)
        if kernel is not None:
            return kernel, nbytes
    # bf16 without a keep mask, a mask or a key bias: fewer than 16 queries
    # over more than 16 keys, where neither mma kernel takes it
    nokeep = bf16 and not has_keep and not has_bias and sq < 16 and sk > 16
    keep_bytes = (_keep_kernel(bf16, sq, sk, hd, False, limit, has_keep)
                  if has_keep or nokeep else None)
    if keep_bytes is not None:
        return ("mma_keep" if has_keep else "mma_nokeep"), keep_bytes
    if bf16 and not has_keep and hd in TC_HEAD_SIZES:
        short = sq <= 16 and sk <= 16
        if wide:
            kernel = "mma_wide_short" if short else "mma_wide"
        else:
            kernel = "mma_short" if short else "mma" if sq >= 16 and sk >= 16 else None
            if (kernel == "mma" and hd == SM90_HEAD and sk >= SM90_MIN_SK
                    and SM90_SMEM <= limit and sm90_faster(sk)):
                kernel = "mma_sm90"  # past 128 keys: the Hopper kernel
        if kernel is not None:
            nbytes = _smem_bytes(kernel, sk, hd)
            if nbytes <= limit or not wide:
                return (kernel if nbytes <= limit else None), nbytes
            # a wide head whose probabilities pass the limit: the FMA kernels
    elif bf16 and not has_keep and 128 < hd < 512:
        return None, 0  # zero-padded to a wide tensor-core head
    if sk <= STAGED_MAX_SK and _smem_bytes("staged", sk, hd) <= limit:
        return "staged", _smem_bytes("staged", sk, hd)
    kernel = "tiled" if hd in (32, 64, 128) else "wide" if wide else None
    if kernel is None:
        return None, 0
    nbytes = _smem_bytes(kernel, sk, hd)
    return (kernel if nbytes <= limit else None), nbytes


_DEVICE_LIMITS: dict[int, int] = {}


def smem_limit(device: torch.device | None = None) -> int:
    """The opt-in shared memory per block that plans a call on ``device``:
    the card's own (asked of the kernel library once per card), an H100's
    for the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return H100_SMEM_OPTIN
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _DEVICE_LIMITS:
        with torch.cuda.device(index):
            _DEVICE_LIMITS[index] = int(_build.library().qt_smem_optin())
    return _DEVICE_LIMITS[index]


def attention_plan(dtype: torch.dtype, sq: int, sk: int, hd: int, has_keep: bool = False,
                   limit: int = H100_SMEM_OPTIN, has_bias: bool = False) -> AttentionPlan:
    """The kernel the card's ``qt::attention`` takes for a call of this dtype
    and shape, in pure Python (``has_bias``: the call adds an additive mask
    or a key bias): with a keep mask the keep-masked tensor-core kernel
    ("mma_keep", bf16 and fp32) at head sizes 32/64/128 over at most 128
    keys; fp32 without a keep mask at head sizes 32/64/128 the same kernel
    without its keep multiply ("mma_nokeep") over at most 128 keys, its
    key-tiled form ("mma_nokeep_tiled") past that, a mask or key bias
    included, and at 256/512 without a mask or key bias the lane split
    ("lane_split"), each where its shared memory fits ``limit``; bf16
    without a keep mask or bias "mma_nokeep" for fewer than 16 queries over
    17-128 keys; the tensor-core routes for bf16 without a keep
    mask at head sizes 32/64/128 and 256/512 (there while the probabilities
    fit ``limit``), at head size 64 past 128 keys the Hopper kernel
    ("mma_sm90", route "wgmma") where its shared memory fits and
    ``sm90_faster`` holds; else the staged FMA kernel where its shared memory fits
    ``limit``, else the tiled (head sizes 32/64/128) or wide-head (256/512)
    kernel. A call no kernel takes at head size ``hd``
    runs zero-padded at the next size one takes (zero lanes add nothing to
    q·kᵀ and give zero context lanes, which the wrapper drops). Raises
    ``ValueError`` naming the shape when no size fits."""
    bf16 = dtype == torch.bfloat16
    for head in (hd, *(s for s in KERNEL_HEAD_SIZES if s > hd)):
        kernel, nbytes = _kernel_at(bf16, sq, sk, head, has_keep, has_bias, limit)
        if kernel is not None:
            return AttentionPlan(KERNEL_ROUTES.get(kernel, "fma"), kernel, head, nbytes)
    raise ValueError(
        f"no attention kernel takes Sq={sq}, Sk={sk}, head size {hd} ({dtype}): its shared "
        f"memory would pass the {limit}-byte limit per block, and head sizes past "
        f"{KERNEL_HEAD_SIZES[-1]} have no key-tiled kernel")


def attention_bwd_plan(dtype: torch.dtype, sq: int, sk: int, hd: int, has_keep: bool = True,
                       limit: int = H100_SMEM_OPTIN) -> AttentionPlan:
    """The kernel of the card's ``qt::attention_bwd`` (the train kernels'
    attention backward, ``qt::attention_bwd_plan``): with a keep mask at
    head sizes 32/64/128 over at most 128 keys the keep-masked tensor-core
    backward ("mma_keep") where its shared memory (which grows with sq)
    fits ``limit``; else the FMA backward ("staged": the whole head staged
    in fp32) where its shared memory fits. It runs at ``hd`` itself (the
    train kernels' heads are never padded); raises ``ValueError`` naming the
    shape when nothing fits."""
    bf16 = dtype == torch.bfloat16
    nbytes = _keep_kernel(bf16, sq, sk, hd, True, limit) if has_keep else None
    if nbytes is not None:
        return AttentionPlan("mma_keep", "mma_keep", hd, nbytes)
    nbytes = 4 * ((2 * sq + 2 * sk) * (hd + 1) + 2 * sq * sk + _ATT_WARPS * sk)
    if nbytes <= limit:
        return AttentionPlan("fma", "staged", hd, nbytes)
    raise ValueError(f"no attention backward takes Sq={sq}, Sk={sk}, head size {hd} "
                     f"({dtype}): its shared memory would pass the {limit}-byte limit")


def keep_rows(shapes) -> torch.Tensor:
    """The attention rows of one planned launch (a train kernel, the eval
    PatchSelecter, or one of their tensor-parallel stages): one int32 row
    (Sq, Sk, kernel) per attention (sq, sk) of ``shapes`` in launch order,
    kernel -1 until the launcher writes the ``KERNEL_NAMES`` code of the
    kernel it launched (``GemmPlan::attention``, ``csrc/gemm_tf32x3.cuh``).
    The launcher refuses a launch whose attentions differ from the rows."""
    return torch.tensor([(sq, sk, -1) for sq, sk in shapes], dtype=torch.int32).reshape(-1, 3)


def note_keep_routes(kernel, rows: torch.Tensor) -> None:
    """Adds one to ``kernel.attn_routes[name]`` for each attention of a
    launch, ``name`` the kernel it wrote into its row (``keep_rows``)."""
    for code in rows[:, 2].tolist():
        name = KERNEL_NAMES[code] if code >= 0 else "none"
        kernel.attn_routes[name] = kernel.attn_routes.get(name, 0) + 1


def library_bwd_plan(dtype: torch.dtype, sq: int, sk: int, hd: int,
                     has_keep: bool = True) -> tuple[str | None, int]:
    """(kernel, shared memory bytes) of the library's
    ``qt_attention_bwd_plan`` on the current card: the card's answer that
    ``attention_bwd_plan`` is held to. Builds the library."""
    import ctypes

    nbytes = ctypes.c_longlong(0)
    code = _build.library().qt_attention_bwd_plan(_build.dtype_code(dtype), sq, sk, hd,
                                                  int(has_keep), ctypes.byref(nbytes))
    return (KERNEL_NAMES[code] if code >= 0 else None), nbytes.value


def library_plan(dtype: torch.dtype, sq: int, sk: int, hd: int,
                 has_keep: bool = False, has_bias: bool = False) -> tuple[str | None, int]:
    """(kernel, shared memory bytes) that the library's
    ``qt_attention_plan`` gives at head size ``hd`` on the current card: the
    card's answer that ``attention_plan`` is held to. Builds the library."""
    import ctypes

    nbytes = ctypes.c_longlong(0)
    code = _build.library().qt_attention_plan(_build.dtype_code(dtype), sq, sk, hd,
                                              int(has_keep), int(has_bias), ctypes.byref(nbytes))
    return (KERNEL_NAMES[code] if code >= 0 else None), nbytes.value


def attention_route(dtype: torch.dtype, sq: int, sk: int, hd: int,
                    has_keep: bool = False, has_bias: bool = False) -> str:
    """The kernel family the card's dispatch (``qt::attention``) takes for a
    call of this dtype and shape: "mma_short" (tensor cores, a warp per
    problem of at most 16 queries and keys: kernels mma_short and
    mma_wide_short), "mma" (tensor cores, 64 query rows per block: mma and
    mma_wide), "wgmma" (the Hopper kernel mma_sm90: TMA and wgmma, 128
    query rows per block), "mma_keep" (a keep mask on tensor cores), "mma_nokeep" (the
    keep-masked kernel without a keep mask, and its key-tiled form),
    "tf32x3" (the lane split's stages) or "fma", at the head size the
    wrapper launches (``attention_plan``; ``has_bias``: an additive mask or
    a key bias). Asks the kernel library, so it builds it on first use."""
    head = attention_plan(dtype, sq, sk, hd, has_keep, has_bias=has_bias).head
    code = _build.library().qt_attention_route(_build.dtype_code(dtype), sq, sk, head,
                                               int(has_keep), int(has_bias))
    return ROUTES[code]


def set_sm90_mode(mode: str) -> str:
    """Sets the Hopper kernel's measurement switch on the library (one of
    SM90_MODES: "default", the plan every call gets; "off", its calls
    planned on ``attention_mma_kernel``,
    which the library then reports; "always", the Hopper kernel at every
    head-64 length past 128 keys, ``sm90_faster`` or not) and returns the
    mode before. ``chip_smoke.py`` and the card's tests time and test the
    kernel's alternatives on the same inputs this way and set "default"
    back; no caller of the port sets it. The Python plan is the default's."""
    return SM90_MODES[_build.library().qt_attention_sm90_mode(SM90_MODES.index(mode))]


def _wide_reference(q, k, v, mask, scale, heads, key_bias=None):
    """Plain version: fp32 scores (plus mask and key bias), fp32 softmax,
    probabilities cast to v's dtype, context in q's dtype."""
    B, Sq, W = q.shape
    Sk = k.shape[1]
    hd = W // heads
    q4 = q.reshape(B, Sq, heads, hd).float()
    k4 = k.reshape(B, Sk, heads, hd).float()
    v4 = v.reshape(B, Sk, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * scale
    if mask is not None:
        logits = logits + mask.float()
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v4.float())
    return ctx.to(q.dtype).reshape(B, Sq, W)


def _check_rows(name: str, t: torch.Tensor, B: int, W: int) -> None:
    if t.dim() != 3 or t.shape[0] != B or t.shape[2] != W:
        raise ValueError(f"{name} must be [B={B}, S, W={W}], got {tuple(t.shape)}")
    if t.stride(2) != 1:
        raise ValueError(f"{name} needs unit stride along its last dim")


def _check_qkv(q, k, v, heads: int) -> None:
    """What the kernels take: q [B, Sq, W], k/v [B, Sk, W] of one dtype on
    one device, unit stride along W, W // heads a head size they run."""
    B, Sq, W = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, B, W)
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if v.shape[1] != k.shape[1]:
        raise ValueError("k and v need the same length")
    if W % heads:
        raise ValueError(f"width {W} does not split into {heads} heads")
    _kernel_head(W // heads, k.shape[1], q.dtype, Sq, smem_limit(q.device))


def _kernel_head(hd: int, sk: int, dtype: torch.dtype = torch.float32, sq: int = 1,
                 limit: int = H100_SMEM_OPTIN) -> int:
    """The head size the card's kernel runs a call at (``attention_plan``):
    ``hd`` itself, or the next size a kernel takes; raises naming the shape
    when none does."""
    return attention_plan(dtype, sq, sk, hd, limit=limit).head


def _kernel_operand(t: torch.Tensor, heads: int, hd: int, hdp: int,
                    kernel: str | None = None) -> torch.Tensor:
    """``t`` [B, S, heads * hd] as the planned kernel reads it: each head
    zero-padded to ``hdp`` lanes where ``hdp > hd``; a contiguous copy where
    a tensor-core kernel's 16-byte ``cp.async`` could not read it (a base
    off 16 bytes, a batch or row stride not a whole 16 bytes: any bf16
    operand, and an fp32 one of a ``kernel`` in FP32_TC_KERNELS). Neither
    changes the route, which depends on dtype and shape alone."""
    if hdp != hd:
        B, S, _ = t.shape
        return torch.nn.functional.pad(t.reshape(B, S, heads, hd),
                                       (0, hdp - hd)).reshape(B, S, heads * hdp)
    per = 16 // t.element_size()
    if ((t.dtype == torch.bfloat16 or kernel in FP32_TC_KERNELS)
            and (t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _device_mask(mask, Sq: int, Sk: int, device):
    if mask is None:
        return None
    if tuple(mask.shape) != (Sq, Sk):
        raise ValueError(f"mask must be [{Sq}, {Sk}], got {tuple(mask.shape)}")
    return mask.to(device=device, dtype=torch.float32).contiguous()


def attention_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None, scale: float, heads: int,
                   key_bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q_h k_h^T * scale + mask + key_bias[:, None, :]) v_h for every
    head h, concatenated back along lanes -> [B, Sq, W].

    q [B, Sq, W], k/v [B, Sk, W]; each may be a column slice of a packed
    projection (rows strided, last dim contiguous). ``mask`` is an additive
    [Sq, Sk] mask or None; ``key_bias`` a [B, Sk] bias (taken in fp32) or
    None.
    """
    if q.device.type == "cpu":
        return _wide_reference(q, k, v, mask, scale, heads, key_bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_wide runs on cpu or cuda, not {q.device}")
    _check_qkv(q, k, v, heads)
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    mask = _device_mask(mask, Sq, Sk, q.device)
    consts = dict(scale=scale, heads=heads)
    if key_bias is None:
        return _grad.apply_masked(_launch, _wide_reference, consts, q, k, v, mask=mask)
    if tuple(key_bias.shape) != (B, Sk) or key_bias.device != q.device:
        raise ValueError(f"key_bias must be [{B}, {Sk}] on {q.device}, got "
                         f"{tuple(key_bias.shape)} on {key_bias.device}")
    key_bias = key_bias.float().contiguous()
    return _grad.apply_masked(_launch, _wide_reference_kb, consts, q, k, v, key_bias, mask=mask)


def attention_wide_key_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            key_bias: torch.Tensor, scale: float, heads: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """``attention_wide`` with a key bias: ToMe's proportional attention
    (``models/vit.py``). Its ``launches`` counts the key-bias launches,
    which ``attention_wide.launches`` counts too."""
    return attention_wide(q, k, v, mask, scale, heads, key_bias=key_bias)


def _wide_reference_kb(q, k, v, key_bias, *, mask, scale, heads):
    return _wide_reference(q, k, v, mask, scale, heads, key_bias)


def _plan_of(q, k, mask, key_bias, heads: int) -> AttentionPlan:
    """``attention_plan`` of a call on the card, at the card's limit."""
    return attention_plan(q.dtype, q.shape[1], k.shape[1], q.shape[2] // heads,
                          limit=smem_limit(q.device),
                          has_bias=mask is not None or key_bias is not None)


def _lane_scratch(plan: AttentionPlan, B: int, Sq: int, Sk: int, device):
    """The lane split's fp32 scores of one head [B, Sq, Sk], which every
    head reuses in turn; None for any other kernel."""
    if plan.kernel != "lane_split":
        return None
    return torch.empty(B, Sq, Sk, dtype=torch.float32, device=device)


def _launch(q, k, v, key_bias=None, *, mask, scale, heads):
    import ctypes

    B, Sq, W = q.shape
    hd = W // heads
    plan = _plan_of(q, k, mask, key_bias, heads)
    hdp = plan.head
    q, k, v = (_kernel_operand(t, heads, hd, hdp, plan.kernel) for t in (q, k, v))
    out = torch.empty(B, Sq, heads * hdp, dtype=q.dtype, device=q.device)
    launched = ctypes.c_int(-1)
    scratch = _lane_scratch(plan, B, Sq, k.shape[1], q.device)
    _build.launch(
        "qt_attention", _build.dtype_code(q),
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        out.data_ptr(), out.stride(0), out.stride(1),
        _build.ptr(mask), _build.ptr(key_bias), B, Sq, k.shape[1], heads, hdp,
        float(scale), ctypes.byref(launched), _build.ptr(scratch))
    attention_wide.launches += 1
    name = KERNEL_NAMES[launched.value] if launched.value >= 0 else "none"
    attention_wide.attn_routes[name] = attention_wide.attn_routes.get(name, 0) + 1
    if key_bias is not None:
        attention_wide_key_bias.launches += 1
    if hdp != hd:
        out = out.reshape(B, Sq, heads, hdp)[..., :hd].reshape(B, Sq, W)
    return out


attention_wide.launches = 0
attention_wide.attn_routes = {}  # the kernel each launch took, as the library wrote it
attention_wide_key_bias.launches = 0


# ---------------------------------------------------------------------------
# attention_wide's tensor-parallel form for one head split by lanes
# ---------------------------------------------------------------------------

def tp_scores_route(dtype: torch.dtype, sq: int, sk: int) -> str:
    """The kernel family of both lane-split stages, ``attention_wide_tp_scores``
    and ``attention_wide_tp_pv`` (``csrc/attention_tp.cuh``): the products on
    ``mma.sync`` in bf16 ("mma"), on 3xTF32 in fp32 ("tf32x3"); "_short"
    where at most TP_SHORT_MAX queries and keys make a problem one warp's,
    else 64 query rows a block."""
    family = "mma" if dtype == torch.bfloat16 else "tf32x3"
    return f"{family}_short" if sq <= TP_SHORT_MAX and sk <= TP_SHORT_MAX else family


def tp_partial_scores(q, k):
    """The first stage's plain version: the fp32 product q kᵀ [B, Sq, Sk]
    over the given lanes, unscaled."""
    return torch.einsum("bqd,bkd->bqk", q.float(), k.float())


def tp_probs(scores: torch.Tensor, mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """The fp32 probabilities of the summed scores: scaled, then masked,
    then the softmax."""
    logits = scores * scale
    if mask is not None:
        logits = logits + mask.float()
    return torch.softmax(logits, dim=-1)


def tp_context(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B, Sq, Sk] cast to v's dtype, times v [B, Sk, W] summed in
    fp32, in v's dtype."""
    return torch.einsum("bqk,bkd->bqd", probs.to(v.dtype).float(), v.float()).to(v.dtype)


def _tp_pv_plain(scores, v, *, mask, scale):
    """Plain version of the second stage."""
    return tp_context(tp_probs(scores, mask, scale), v)


def attention_wide_tp_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One model rank's stage 1 of one-head ``attention_wide`` split by
    lanes: q [B, Sq, W] and k [B, Sk, W], the rank's W lanes of the head ->
    the fp32 partial scores [B, Sq, Sk], unscaled (the sum over the ranks
    is the single-rank kernel's fp32 product; the scale comes after it, as
    there). Counts one ``attention_wide`` launch. Its gradient is its plain
    version's."""
    if q.device.type == "cpu":
        return tp_partial_scores(q, k)
    _check_tp_rows(q, k)
    return _grad.KernelWithPlainGrad.apply(_launch_tp_scores, tp_partial_scores, {}, q, k)


def attention_wide_tp_pv(scores: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None,
                         scale: float) -> torch.Tensor:
    """Stage 2 on the summed scores [B, Sq, Sk] (fp32): scale, the additive
    [Sq, Sk] ``mask``, the row max and sum, p cast to v's dtype, p v_r in
    fp32 -> the rank's context lanes [B, Sq, W] in v's dtype. Its gradient
    is its plain version's (a mask that requires grad gets one)."""
    if scores.device.type == "cpu":
        return _tp_pv_plain(scores, v, mask=mask, scale=scale)
    B, Sq, Sk = scores.shape
    if scores.dtype != torch.float32 or v.device != scores.device:
        raise ValueError("the summed scores must be fp32 on v's device")
    _check_rows("v", v, B, v.shape[-1])
    if v.shape[1] != Sk:
        raise ValueError(f"v needs the scores' {Sk} keys, got {v.shape[1]}")
    mask = _device_mask(mask, Sq, Sk, v.device)
    return _grad.apply_masked(_launch_tp_pv, _tp_pv_plain, dict(scale=scale),
                              scores.contiguous(), v, mask=mask)


def _check_tp_rows(q, k) -> None:
    B, _, W = q.shape
    _check_rows("q", q, B, W)
    _check_rows("k", k, B, W)
    if k.dtype != q.dtype or k.device != q.device:
        raise ValueError("k must match q's dtype and device")


def _lane_slabs(t: torch.Tensor) -> torch.Tensor:
    """An operand as the lane-split kernels read it: lanes zero-padded to
    whole 128-byte slabs, 64 bf16 or 32 fp32 (zero lanes add nothing to
    q·kᵀ and give zero context lanes, dropped), a contiguous copy where
    16-byte ``cp.async`` copies could not read it (a base off 16 bytes, a
    batch or row stride off whole 16 bytes)."""
    per = 16 // t.element_size()
    extra = -t.shape[-1] % (8 * per)
    if extra:
        return torch.nn.functional.pad(t, (0, extra))
    if t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _launch_tp_scores(q, k):
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    q, k = _lane_slabs(q), _lane_slabs(k)
    s = torch.empty(B, Sq, Sk, dtype=torch.float32, device=q.device)
    _build.launch("qt_attention_tp_scores", _build.dtype_code(q), q.data_ptr(), q.stride(0),
                  q.stride(1), k.data_ptr(), k.stride(0), k.stride(1), s.data_ptr(), B, Sq, Sk,
                  q.shape[-1])
    attention_wide_tp_scores.launches += 1
    attention_wide.launches += 1
    return s


def _launch_tp_pv(scores, v, *, mask, scale):
    B, Sq, Sk = scores.shape
    W = v.shape[-1]
    v = _lane_slabs(v)
    out = torch.empty(B, Sq, v.shape[-1], dtype=v.dtype, device=v.device)
    _build.launch("qt_attention_tp_pv", _build.dtype_code(v), scores.data_ptr(), v.data_ptr(),
                  v.stride(0), v.stride(1), _build.ptr(mask), out.data_ptr(), out.stride(0),
                  out.stride(1), B, Sq, Sk, v.shape[-1], float(scale))
    attention_wide_tp_pv.launches += 1
    return out[..., :W] if v.shape[-1] != W else out


attention_wide_tp_scores.launches = 0
attention_wide_tp_pv.launches = 0


# ---------------------------------------------------------------------------
# fused_attention: [BH, S, dh], one head per batch row
# ---------------------------------------------------------------------------

def _softmax_pv(qs, k, v, mask):
    """fp32 scores of the already scaled fp32 queries ``qs``, + mask, fp32
    softmax, p cast to v's dtype, p v summed in fp32."""
    s = torch.einsum("bqd,bkd->bqk", qs, k.float())
    if mask is not None:
        s = s + mask.float()
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p.float(), v.float())


def _fused_attention_plain(q, k, v, *, mask, scale):
    """The forward's plain version, the Pallas ``_kernel``'s arithmetic: q
    cast to fp32 and scaled, then the fp32 dot with k."""
    return _softmax_pv(q.float() * scale, k, v, mask).to(q.dtype)


def _fused_attention_rule(q, k, v, *, mask, scale):
    """The gradient's plain version, ``_reference_impl``, which the JAX
    ``custom_vjp`` recomputes: q scaled in its own dtype, then the fp32 dot.
    The two agree in fp32; in bf16 ``q * scale`` is rounded here."""
    return _softmax_pv((q * scale).float(), k, v, mask).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v for q [BH, Sq, dh], k/v [BH, Sk, dh];
    ``mask`` is an additive [Sq, Sk] mask or None.

    On the card ``qt_fused_attention`` takes both Pallas routes (the
    per-row ``_kernel`` and the packed ``_packed_kernel`` for tiny unmasked
    sequences): packing was a layout for the TPU's matrix unit and computes
    the same function; in bf16 such tiny problems take the short
    tensor-core kernel, one warp each (``attention_route`` "mma_short").
    The kernel scales the fp32 dot rather than q, which differs from
    ``_fused_attention_plain`` by fp32 rounding only. On either
    device the gradient is that of ``_fused_attention_rule``; a mask that
    requires grad gets its cotangent.
    """
    if q.device.type == "cpu":
        return _grad.apply_masked(_fused_attention_plain, _fused_attention_rule,
                                  dict(scale=scale), q, k, v, mask=mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    _check_qkv(q, k, v, 1)
    mask = _device_mask(mask, q.shape[1], k.shape[1], q.device)
    return _grad.apply_masked(_launch_fused, _fused_attention_rule, dict(scale=scale),
                              q, k, v, mask=mask)


def _launch_fused(q, k, v, *, mask, scale):
    BH, Sq, dh = q.shape
    plan = _plan_of(q, k, mask, None, 1)
    dhp = plan.head
    q, k, v = (_kernel_operand(t, 1, dh, dhp, plan.kernel) for t in (q, k, v))
    out = torch.empty(BH, Sq, dhp, dtype=q.dtype, device=q.device)
    scratch = _lane_scratch(plan, BH, Sq, k.shape[1], q.device)
    _build.launch(
        "qt_fused_attention", _build.dtype_code(q),
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        out.data_ptr(), _build.ptr(mask), BH, Sq, k.shape[1], dhp, float(scale),
        _build.ptr(scratch))
    fused_attention.launches += 1
    return out[..., :dh].contiguous() if dhp != dh else out


fused_attention.launches = 0
