"""The plan of the Hopper attention kernel ("mma_sm90", route "wgmma",
``csrc/attention_sm90.cuh``) on the CPU: which model-path calls it takes,
its shared memory, and the C constants the Python plan mirrors.

The kernel takes bf16 calls without a keep mask at head size 64 with at
least 16 queries over more than 128 keys where the measured rule
``sm90_faster`` holds (past 384 keys, or a last 128-key tile more than half
full or full): the CLIP image tower's 577 tokens and ToMe's layers of
327-577 and 202-252 tokens, with and without the key bias. Every other bf16
call keeps its kernel: ToMe's layers of 277, 302, 152 and 177 tokens and of
at most 128, the text towers' 77, AVQ's 60 x 77, head sizes 32 and 128.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``gpu`` marker), where it is also held to the tight bf16 bound of
``_keep_bounds.wide_flips``; here that bound is shown to see a plain version
whose probabilities are rounded at another point.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _keep_bounds import check_bf16, wide_flips
from qa_tiger_tpu_torch.ops import attention as A
from qa_tiger_tpu_torch.ops.tome import tome_schedule

CSRC = Path(__file__).resolve().parents[1] / "qa_tiger_tpu_torch" / "csrc"
BF = torch.bfloat16
# ToMe at r = 25 over 24 layers: layer 0 attends over 577 tokens without a
# key bias, layer l over the tokens the merges left, with one
TOME_TOKENS = [577] + [n for _, n in tome_schedule(577, [25] * 23)]
# (label, Sq, Sk, head size, mask or key bias, kernel) of the bf16 calls of
# the raw-media forward, the CLIP and text towers and the QA-TIGER head
MODEL_CALLS = ([("clip_image", 577, 577, 64, False, "mma_sm90"),
                ("text_vitl14", 77, 77, 64, True, "mma"),
                ("text_rn50", 77, 77, 64, True, "mma"),
                ("avq_question", 60, 77, 64, False, "mma"),
                ("avq_self", 60, 60, 64, False, "mma"),
                ("patch_select", 14, 14, 64, False, "mma_short"),
                ("tempmoe", 1, 60, 64, False, "mma_nokeep")]
               + [(f"tome_layer{layer}", n, n, 64, layer > 0,
                   "mma_sm90" if n > 128 and (n > 384 or n % 128 > 64) else
                   "mma" if n >= 16 else "mma_short")
                  for layer, n in enumerate(TOME_TOKENS[:24])])
# the ToMe layers the measured rule keeps on attention_mma_kernel's two-pass
# form (their last 128-key tile at most half full, at most 3 tiles)
TOME_DECLINED = (302, 277, 177, 152)


def test_tome_tokens():
    """The layers past 128 tokens are 0-17 (577 down to 152); the rule
    declines four of them."""
    assert TOME_TOKENS[:3] == [577, 552, 527]
    assert [n for n in TOME_TOKENS[:24] if n > 128] == [577 - 25 * i for i in range(18)]
    assert tuple(n for n in TOME_TOKENS[:18] if not A.sm90_faster(n)) == TOME_DECLINED


@pytest.mark.parametrize("label,sq,sk,hd,bias,want", MODEL_CALLS,
                         ids=[c[0] for c in MODEL_CALLS])
def test_model_path_plans(label, sq, sk, hd, bias, want):
    """Each bf16 model-path call takes the kernel ``want`` at its own head
    size, within an H100's shared memory."""
    plan = A.attention_plan(BF, sq, sk, hd, has_bias=bias)
    assert plan.kernel == want and plan.head == hd
    assert plan.route == A.KERNEL_ROUTES[want]
    assert plan.smem_bytes <= A.H100_SMEM_OPTIN


# (Sk, the Hopper kernel takes it): around 128 keys, the residues of 3
# tiles, past 384 keys
RULE = [(128, False), (129, False), (192, False), (193, True), (256, True), (257, False),
        (320, False), (321, True), (384, True), (385, True), (402, True), (640, True),
        (641, True), (1000, True)]


@pytest.mark.parametrize("sq", [16, 17, 100, 577, 1000])
@pytest.mark.parametrize("sk,takes", RULE)
@pytest.mark.parametrize("bias", [False, True])
def test_the_rule(sq, sk, takes, bias):
    """At head size 64 and at least 16 queries: the Hopper kernel past 128
    keys where ``sm90_faster`` holds, else attention_mma_kernel (its one
    pass up to 128 keys); a keep mask and fp32 never take it."""
    assert A.sm90_faster(sk) == takes or sk <= 128
    plan = A.attention_plan(BF, sq, sk, 64, has_bias=bias)
    want = ("wgmma", "mma_sm90", 64, A.SM90_SMEM) if takes else ("mma", "mma", 64, 46_080)
    assert tuple(plan) == want
    assert A.attention_plan(BF, sq, sk, 64, has_keep=True).kernel != "mma_sm90"
    assert A.attention_plan(torch.float32, sq, sk, 64, has_bias=bias).kernel != "mma_sm90"


@pytest.mark.parametrize("hd,want_head,want", [(32, 32, "mma"), (48, 64, "mma_sm90"),
                                               (64, 64, "mma_sm90"), (80, 128, "mma"),
                                               (128, 128, "mma"), (256, 256, "mma_wide")])
def test_head_sizes(hd, want_head, want):
    """Only a 64-lane head takes the Hopper kernel (48 lanes padded to it);
    32 and 128 keep the two-pass mma kernel, 256 the wide one."""
    plan = A.attention_plan(BF, 577, 577, hd)
    assert (plan.head, plan.kernel) == (want_head, want)


def test_fewer_than_16_queries_keep_their_kernel():
    """One query over 577 keys has no tensor-core kernel in bf16: the FMA
    key-tiled kernel, as before."""
    assert A.attention_plan(BF, 1, 577, 64).kernel == "tiled"
    assert A.attention_plan(BF, 15, 577, 64, has_bias=True).kernel == "tiled"


def test_shared_memory_and_limit():
    """Its shared memory: two 128-row Q tiles, 5 K and 3 V stages of 128 x
    128 bytes, 5 key-bias rows of 128 floats, 20 barriers, 1 KB of slack;
    a card whose limit is below it keeps the mma kernel."""
    assert A.SM90_SMEM == 1024 + (2 + 5 + 3) * 128 * 128 + 5 * 128 * 4 + 20 * 8 == 167_584
    assert A.SM90_SMEM <= A.H100_SMEM_OPTIN
    assert A.attention_plan(BF, 577, 577, 64, limit=150_000).kernel == "mma"


def test_c_constants_match_python():
    """common.cuh's kernel and route codes, the geometry and the key limit,
    read from the source, are the Python plan's."""
    text = (CSRC / "common.cuh").read_text()
    kernels = dict(re.findall(r"ATT_KERNEL_(\w+) = (-?\d+)",
                              re.search(r"enum AttentionKernel \{(.*?)\};", text, re.S).group(1)))
    assert int(kernels["MMA_SM90"]) == A.KERNEL_NAMES.index("mma_sm90") == 11
    routes = dict(re.findall(r"ATT_ROUTE_(\w+) = (\d+)",
                             re.search(r"enum AttentionRoute \{(.*?)\};", text, re.S).group(1)))
    assert int(routes["WGMMA"]) == A.ROUTES.index("wgmma") == 6
    geo = re.search(r"constexpr int AS9_Q = (\d+), AS9_K = (\d+), AS9_KSTAGES = (\d+), "
                    r"AS9_VSTAGES = (\d+);", text)
    assert tuple(int(g) for g in geo.groups()) == (A._AS9_Q, A._AS9_K, A.SM90_KSTAGES,
                                                   A.SM90_VSTAGES)
    assert re.search(r"ATT_SM90_MIN_SK = 2 \* AM_K \+ 1;", text) and A.SM90_MIN_SK == 129
    assert ("return Sk > 3 * AS9_K || Sk % AS9_K == 0 || Sk % AS9_K > AS9_K / 2;" in text
            and all(A.sm90_faster(n) == (n > 384 or n % 128 in range(65, 128) or n % 128 == 0)
                    for n in range(129, 1200)))
    modes = dict(re.findall(r"ATT_SM90_(\w+) = (\d+)",
                            re.search(r"enum Sm90Mode \{(.*?)\};", text, re.S).group(1)))
    assert [m.lower() for m, _ in sorted(modes.items(), key=lambda kv: int(kv[1]))] == list(
        A.SM90_MODES)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """On the CPU ``attention_wide`` at a Hopper-kernel shape is the plain
    version (the tensor lies on the CPU); nothing is built."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 150, 128, generator=g).to(BF) for _ in range(3))
    kb = torch.randn(2, 150, generator=g)
    got = A.attention_wide(q, k, v, None, 0.125, 2, key_bias=kb)
    assert torch.equal(got, A._wide_reference(q, k, v, None, 0.125, 2, kb))


def _rounded_elsewhere(q, k, v, scale, heads, key_bias, how):
    """attention_wide's plain version (no mask) with the contract's rounding
    point p = round(exp(s - m) / l) done otherwise: "unrounded" leaves p in
    fp32; "before_division" rounds exp(s - m) and divides the context by the
    row's sum, as a one-pass online softmax does; "fp64" computes every step
    in fp64 and rounds p and ctx where the contract does (a correct version
    with another arithmetic)."""
    B, Sq, W = q.shape
    hd = W // heads
    dt = torch.float64 if how == "fp64" else torch.float32
    q4, k4, v4 = (x.to(dt).reshape(B, -1, heads, hd) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q4, k4) * scale
    if key_bias is not None:
        s = s + key_bias.to(dt)[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    if how == "unrounded":
        ctx = torch.einsum("bhqk,bkhd->bqhd", e / l, v4)
    elif how == "before_division":
        ctx = (torch.einsum("bhqk,bkhd->bhqd", e.to(BF).to(dt), v4) / l).transpose(1, 2)
    else:
        ctx = torch.einsum("bhqk,bkhd->bqhd", (e / l).to(BF).to(dt), v4)
    return ctx.to(BF).reshape(B, Sq, W)


@pytest.mark.parametrize("how", ["unrounded", "before_division", "fp64"])
@pytest.mark.parametrize("n,bias", [(577, False), (552, True)])
def test_bf16_bound_sees_a_moved_rounding(n, bias, how):
    """The tight bf16 bound the card holds the Hopper kernel to
    (``wide_flips``: one ulp plus the terms whose p lies at a rounding
    boundary and the fp32 order of a sum of Sk terms) at the CLIP image
    tower's 577 tokens and ToMe's key-bias 552, 2 heads of 64 over 2 batch
    elements: a plain version that leaves p unrounded or rounds it before
    the division by the row's sum fails it; one that rounds where the
    contract does, in fp64, passes."""
    rng = np.random.default_rng(n)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 128), dtype=np.float32)).to(BF)
               for _ in range(3))
    kb = torch.from_numpy(np.log(rng.integers(1, 41, (2, n))).astype(np.float32)) \
        if bias else None
    want = A._wide_reference(q, k, v, None, 0.125, 2, kb)
    bound = wide_flips(q, k, v, None, 0.125, 2, kb)
    got = _rounded_elsewhere(q, k, v, 0.125, 2, kb, how)
    args = (got.float().numpy(), want.float().numpy(), bound, how)
    if how == "fp64":
        check_bf16(*args)
    else:
        with pytest.raises(AssertionError, match="over their bound"):
            check_bf16(*args)
