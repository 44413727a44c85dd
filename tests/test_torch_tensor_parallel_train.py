"""The port's train step under a data x model grid (``parallel/tensor.py``), on
the CPU.

(a) the modules' train forms: AVQCrossAttn and PatchSelecter under their
    explicit masks (the train kernels' tensor-parallel stages) and without
    dropout (the eval stages under autograd), QstGrounding and TempMoE
    (audio and visual) with their attention dropout, each at tp 2 and 4,
    the ranks simulated as threads (``tests/torch_tp.py``), against the
    unsharded port module on the same whole realization: outputs within
    rtol 1e-5 / atol 2e-6 (TP_TOL), every input and parameter gradient,
    gathered, within 1e-5 of its largest element, and every replicated
    parameter's gradient bitwise equal on the ranks (TempMoE's b2 among
    them: its term is added after the model-group sum on every rank);
(b) each train stage's plain version (``fused_avq_train_tp_*``,
    ``fused_patch_select_train_tp_*`` and their backward stages), the ranks
    run in turn and their partials summed in rank order, against the whole
    train op's plain version under autograd, forward and backward, fp32;
(d) spawned gloo ranks (``tests/torch_dp.py``) at dp1 x tp2 against the
    port's single process, dropout on, three ``train_step`` calls from the
    same step generator: losses within rtol 1e-5, the first step's
    gradients gathered within 1e-5 of each tensor's largest element, the
    replicated parameters bitwise equal on the ranks;
(e) checkpoints across grids: the train state saved at dp1 x tp2 after two
    steps, restored in one process, and the single process's restored at
    dp1 x tp2: the next step within (d)'s tolerances of the uninterrupted
    run; restored into a fresh dp1 x tp2 runner, bitwise;
(f) a grid of model size 1 at world 2 trains bitwise as the data-parallel
    step without a grid;
(g) ``train_window`` (``steps_per_dispatch`` 2) under dp1 x tp2 gloo
    ranks, dropout on: the epoch bitwise the K = 1 epoch; a step graph that
    would capture under gloo raises, naming it.

The dp2 x tp2 ranks against the JAX mesh are in
``test_torch_tensor_parallel_mesh.py``.
"""
import jax
import numpy as np
import pytest
import torch

import torch_dp
import torch_tp
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_init
from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import modules as M
from qa_tiger_tpu_torch.models import qa_tiger_config
from qa_tiger_tpu_torch.ops import avq as AV
from qa_tiger_tpu_torch.ops import patch_select as PS
from qa_tiger_tpu_torch.parallel import Grid, tp_spec
from qa_tiger_tpu_torch.parallel.tensor import merge_shards
from qa_tiger_tpu_torch.training import AVQARunner
from qa_tiger_tpu_torch.training.checkpoint import load_train_state, save_train_state
from qa_tiger_tpu_torch.utils import Box
from torch_corpus import val_questions, write_corpus, write_merges

D, H, B, T, S, P = 32, 8, 2, 5, 9, 14
TINY = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
            encoder_type="tiny-test")
# the eval module forms' tolerance (test_torch_tensor_parallel.py TP_TOL;
# fp32: the split only reorders sums; the modules end in a LayerNorm whose
# 1/std scales that reordering)
TP_TOL = dict(rtol=1e-5, atol=2e-6)
GRAD_TOL = 1e-5  # of each gradient's largest element
LR = 1e-3
DIMS = {"vggish": (12, 16), "clip": (12, 32), "tome": (12, 4, 24)}
SPLITS = {"train": (0, 19), "val": (19, 35), "test": (35, 52)}


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)


def _rn(gen, *shape):
    return torch.randn(*shape, generator=gen)


def _close_grad(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= GRAD_TOL * scale, f"{what}: {err:.3e} of {scale:.3e}"


# ---------------------------------------------------------------------------
# (a) the modules' train forms


def module_case(name: str):
    """(module, inputs, call(module, inputs, grid) -> a tensor) of one
    module's train form at the tiny widths; the dropout realization is
    drawn whole from a fixed seed (every rank draws the same)."""
    g = torch.Generator().manual_seed(MODULES.index(name))
    mg = torch.Generator().manual_seed(3)
    if name.startswith("avq"):
        mod = M.AVQCrossAttn(D, mg)
        ins = [_rn(g, B, T, D), _rn(g, B, T, D), _rn(g, B, S, D)]
        masks = (M.make_avq_dropout_masks(torch.Generator().manual_seed(1), 2 * B, T, S, D,
                                          nhead=H, dropout_p=0.1)
                 if name == "avq_masks" else None)

        def call(m, x, grid):
            return torch.stack(m(*x, nhead=H, masks=masks, grid=grid))
    elif name.startswith("patch"):
        mod = M.PatchSelecter(D, mg)
        ins = [_rn(g, B, T, P, D), _rn(g, B, T, D), _rn(g, B, T, D)]
        masks = (M.make_patch_dropout_masks(torch.Generator().manual_seed(1), B * T, P, D,
                                            nhead=H, dropout_p=0.1)
                 if name == "patch_masks" else None)

        def call(m, x, grid):
            return torch.stack(m(*x, nhead=H, masks=masks, grid=grid))
    elif name == "grounding":
        mod = M.QstGrounding(D, mg)
        ins = [_rn(g, B, D), _rn(g, B, 3, D), _rn(g, B, 4, D)]

        def call(m, x, grid):
            return m(x[0], [x[1], x[2]], nhead=H, dropout_p=0.1,
                     generator=torch.Generator().manual_seed(9), grid=grid)
    else:
        vis = name == "temp_moe_vis"
        mod = M.TempMoE(D, 4, mg, vis_branch=vis)
        ins = [_rn(g, B, D), _rn(g, B, T, D)] + ([_rn(g, B, T, D), _rn(g, B, T, D)] if vis else [])

        def call(m, x, grid):
            out = m(x[0], x[1], [x[2], x[3]] if vis else None, nhead=H, topK=2,
                    gather_mode="paper", generator=torch.Generator().manual_seed(9), grid=grid)
            return torch.stack(out) if vis else out
    return mod, ins, call


def _forward_backward(module, ins, call, grid):
    xs = [x.clone().requires_grad_(True) for x in ins]
    out = call(module, xs, grid)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    params = [p for _, p in module.named_parameters()]
    grads = torch.autograd.grad(out, xs + params, cot, allow_unused=True)
    return out.detach(), grads


MODULES = ["avq_masks", "avq_eval", "patch_masks", "patch_eval", "grounding", "temp_moe",
           "temp_moe_vis"]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", MODULES)
def test_tp_train_module_matches_port(name, tp):
    module, ins, call = module_case(name)
    want_out, want_grads = _forward_backward(module, ins, call, None)
    names = [n for n, _ in module.named_parameters()]

    def rank(grid):
        return _forward_backward(torch_tp.sharded(module, grid), ins, call, grid)

    ranks = torch_tp.run_ranks(tp, rank)
    for out, grads in ranks:
        assert torch.equal(out, ranks[0][0])
        for i in range(len(ins)):  # input gradients: whole and equal on every rank
            assert torch.equal(grads[i], ranks[0][1][i])
    np.testing.assert_allclose(ranks[0][0].numpy(), want_out.numpy(), **TP_TOL)
    for i in range(len(ins)):
        _close_grad(ranks[0][1][i], want_grads[i], f"input {i}")
    replicated = 0
    for j, pname in enumerate(names):
        shards = [grads[len(ins) + j] for _, grads in ranks]
        want = want_grads[len(ins) + j]
        if want is None:
            assert all(s is None for s in shards), pname
            continue
        spec = tp_spec(pname, dict(module.named_parameters())[pname].shape, tp)
        if not spec:
            replicated += 1
            for s in shards[1:]:  # bitwise, not assumed: checked
                assert torch.equal(s, shards[0]), f"{pname}: replicated gradient differs"
        _close_grad(merge_shards(shards, spec) if spec else shards[0], want, pname)
    assert replicated >= 2
    if name.startswith("temp_moe"):  # b2 reaches every rank alike
        b2 = [torch.stack([grads[len(ins) + names.index(f"experts.{e}.2.bias")]
                           for e in range(4)]) for _, grads in ranks]
        assert float(b2[1].abs().max()) > 0 and all(torch.equal(b, b2[0]) for b in b2)


# ---------------------------------------------------------------------------
# (b) the stages' plain versions


def _whole_grads(outs, ins, params, cots):
    return torch.autograd.grad(outs, ins + params, cots)


@pytest.mark.parametrize("tp", [2, 4])
def test_avq_stage_plains_match_the_whole_op(tp):
    g = torch.Generator().manual_seed(7)
    mod = M.AVQCrossAttn(D, torch.Generator().manual_seed(3))
    N = 2 * B
    ins = [_rn(g, N, T, D).requires_grad_(True), _rn(g, N, T, D).requires_grad_(True),
           _rn(g, N, S, D).requires_grad_(True)]
    masks = M.make_avq_dropout_masks(torch.Generator().manual_seed(1), N, T, S, D, nhead=H,
                                     dropout_p=0.1)
    cot = _rn(g, N, T, D)
    want = AV.avq_sub_forward_masked(mod, *ins, masks, nhead=H)
    params = list(mod.parameters())
    want_grads = _whole_grads(want, ins, params, cot)
    names = [n for n, _ in mod.named_parameters()]

    shards = [torch_tp.sharded(mod, Grid(model_rank=r, model_size=tp)) for r in range(tp)]
    states = [AV._AVQState(*[x.detach() for x in ins], AV._weights(s),
                           AV.shard_avq_masks(masks, H, S, T, r, tp), H // tp)
              for r, s in enumerate(shards)]

    summed = torch_tp.sum_in_rank_order
    totals = summed([AV.fused_avq_train_tp_attn(st) for st in states])
    total2 = summed([AV.fused_avq_train_tp_mid(st, totals) for st in states])
    outs = [AV.fused_avq_train_tp_out(st, total2) for st in states]
    for out in outs:
        assert torch.equal(out, outs[0])
    np.testing.assert_allclose(outs[0].detach().numpy(), want.detach().numpy(), **TP_TOL)
    ffn = [AV.fused_avq_train_bwd_tp_ffn(st, cot, r == 0) for r, st in enumerate(states)]
    gh1 = summed([part for part, _ in ffn])
    attn = [AV.fused_avq_train_bwd_tp_attn(st, gh1, r == 0) for r, st in enumerate(states)]
    g_in = summed([part for part, _ in attn])
    R = N * T
    for got, w, label in ((g_in[:R], want_grads[0], "gsrc"),
                          (g_in[R:2 * R], want_grads[1], "gval"),
                          (g_in[2 * R:], want_grads[2], "gwrd")):
        _close_grad(got.reshape(w.shape), w, label)
    for i, wname in enumerate(AV.WEIGHT_NAMES):
        pname = _avq_param_name(i)
        rank_grads = [{**f[1], **a[1]}[i] for f, a in zip(ffn, attn)]
        spec = tp_spec(pname, dict(mod.named_parameters())[pname].shape, tp)
        got = merge_shards(rank_grads, spec) if spec else rank_grads[0]
        if not spec:
            assert all(torch.equal(r, rank_grads[0]) for r in rank_grads), wname
        _close_grad(got, want_grads[3 + names.index(pname)], wname)


def _avq_param_name(i: int) -> str:
    blocks = ("qst_attn", "slf_attn", "crs_attn")
    if i < 12:
        leaf = ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")[i % 4]
        return f"{blocks[i // 4]}.{leaf}"
    mod = ("linear1", "linear2", "norm1", "norm2")[(i - 12) // 2]
    return f"{mod}.{('weight', 'bias')[i % 2]}"


def _ps_param_name(i: int) -> str:
    if i < 8:
        leaf = ("in_proj_weight", "in_proj_bias", "out_proj.weight", "out_proj.bias")[i % 4]
        return f"{('slf_attn', 'crs_attn')[i // 4]}.{leaf}"
    return ("mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias", "anorm.weight",
            "anorm.bias", "vnorm.weight", "vnorm.bias")[i - 8]


@pytest.mark.parametrize("tp", [2, 4])
def test_patch_stage_plains_match_the_whole_op(tp):
    g = torch.Generator().manual_seed(8)
    mod = M.PatchSelecter(D, torch.Generator().manual_seed(3))
    ins = [_rn(g, B, T, P, D).requires_grad_(True), _rn(g, B, T, D).requires_grad_(True),
           _rn(g, B, T, D).requires_grad_(True)]
    masks = M.make_patch_dropout_masks(torch.Generator().manual_seed(1), B * T, P, D, nhead=H,
                                       dropout_p=0.1)
    cots = [_rn(g, B, T, D), _rn(g, B, T, D)]
    want = PS.patch_selecter_plain(mod, *ins, nhead=H, masks=masks)
    params = list(mod.parameters())
    want_grads = _whole_grads(want, ins, params, cots)
    names = [n for n, _ in mod.named_parameters()]

    shards = [torch_tp.sharded(mod, Grid(model_rank=r, model_size=tp)) for r in range(tp)]
    states = [PS._PSState(*[x.detach() for x in ins], PS._weights(s),
                          PS.shard_patch_masks(masks, H, P, r, tp), H // tp)
              for r, s in enumerate(shards)]
    summed = torch_tp.sum_in_rank_order
    total1 = summed([PS.fused_patch_select_train_tp_self(st) for st in states])
    total2 = summed([PS.fused_patch_select_train_tp_cross(st, total1) for st in states])
    total3 = summed([PS.fused_patch_select_train_tp_mlp(st, total2) for st in states])
    outs = [PS.fused_patch_select_train_tp_out(st, total3) for st in states]
    for a, v in outs:
        assert torch.equal(a, outs[0][0]) and torch.equal(v, outs[0][1])
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(got.detach().numpy(), w.detach().numpy(), **TP_TOL)
    mlp = [PS.fused_patch_select_train_bwd_tp_mlp(st, *cots) for st in states]
    cross = [PS.fused_patch_select_train_bwd_tp_cross(st, summed([m[0] for m in mlp]))
             for st in states]
    selves = [PS.fused_patch_select_train_bwd_tp_self(st, summed([c[0] for c in cross]))
              for st in states]
    g_x1, g_video, g_audio = selves[0][:3]
    gpatch = g_x1 + summed([s_[3] for s_ in selves]).reshape(g_x1.shape).to(g_x1.dtype)
    for got, w, label in ((gpatch, want_grads[0], "gpatch"), (g_audio, want_grads[1], "gaudio"),
                          (g_video, want_grads[2], "gvideo")):
        _close_grad(got, w, label)
    for i in range(len(PS.WEIGHT_NAMES)):
        pname = _ps_param_name(i)
        rank_grads = [{**m[1], **c[1], **s_[4]}[i] for m, c, s_ in zip(mlp, cross, selves)]
        spec = tp_spec(pname, dict(mod.named_parameters())[pname].shape, tp)
        got = merge_shards(rank_grads, spec) if spec else rank_grads[0]
        if not spec:
            assert all(torch.equal(r, rank_grads[0]) for r in rank_grads), pname
        _close_grad(got, want_grads[3 + names.index(pname)], pname)


# ---------------------------------------------------------------------------
# (d), (e), (f): spawned gloo ranks


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_train")
    write_corpus(root / "data", SPLITS, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    return root


def cfg_dict(corpus) -> dict:
    return dict(
        type="qa-tiger", mode="train", debug=False, log_interval=100, epochs=1, seed=7,
        num_labels=42,
        data=dict(root=str(corpus / "data"), frame_sample_rate=1, batch_size=8,
                  eval_batch_size=8, train_annot="train.json", valid_annot="val.json",
                  test_annot="test.json", ans_quelen="answer2idx.json", audio_feat="vggish",
                  video_feat="clip", patch_feat="tome", quest_feat=None, prompt_feat=None),
        hyper_params=dict(
            model=dict(TINY),
            optim=dict(lr=LR, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None),
            sched=dict(name="StepLR", step_size=8, gamma=0.1, mode="min", factor=0.5,
                       patience=5)))


def jax_params():
    params = qa_tiger_init(jax.random.PRNGKey(0),
                           j_config(num_labels=42, gather_mode="paper", **TINY))
    return jax.tree_util.tree_map(np.asarray, params)


def model_cfg(dropout=0.1):
    return {**qa_tiger_config(num_labels=42, gather_mode="paper", **TINY), "dropout": dropout}


def _losses_close(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_dp1_tp2_matches_the_single_process(corpus, tmp_path, monkeypatch):
    """(d) and (e): three steps with dropout on, the resumes across grids."""
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    cfg = cfg_dict(corpus)
    params = jax_params()
    loader = BatchLoader(AVQADataset(Box(cfg), mode="train"), 8, prefetch=0)
    batches = [b for _, b in zip(range(3), loader)]
    single = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=0, init_params=params)
    losses, first_grads = [], None
    for i, batch in enumerate(batches):
        if i == 2:
            save_train_state(single.train_state(epoch=1), tmp_path / "single_state")
        losses.append({k: float(v) for k, v in single.train_step(
            batch, LR, single._step_generator).items()})
        if i == 0:
            first_grads = {n: p.grad.clone() for n, p in single.trainable()
                           if p.grad is not None}
    final = {n: p.detach().clone() for n, p in single.trainable()}

    ranks = torch_dp.spawn(torch_tp.train_steps, 2, tmp_path / "ranks", cfg, model_cfg(), params,
                           batches, LR, str(tmp_path / "tp_state"),
                           str(tmp_path / "single_state"))
    for r in ranks:
        for got, want in zip(r["losses"], losses):
            _losses_close(got, want)
        assert set(r["first_grads"]) == set(first_grads)
        for name, want in first_grads.items():
            _close_grad(torch.from_numpy(r["first_grads"][name]), want, name)
        assert r["resume_bitwise"] and r["resume_rng_equal"]
        assert r["resume_loss"] == r["losses"][2]
        _losses_close(r["from_single_loss"], losses[2])
    assert ranks[0]["replicated"].keys() == ranks[1]["replicated"].keys()
    assert len(ranks[0]["replicated"]) > 20
    for name, value in ranks[0]["replicated"].items():
        assert np.array_equal(value, ranks[1]["replicated"][name]), name
    for name, value in ranks[0]["params"].items():
        assert np.array_equal(value, ranks[1]["params"][name]), name
        keep = first_grads[name].abs().numpy() > 1e-6 if name in first_grads else None
        if keep is not None and keep.any():
            np.testing.assert_allclose(value[keep], final[name].numpy()[keep], rtol=2e-4,
                                       atol=2e-5, err_msg=name)

    # the dp1 x tp2 state after two steps, restored in one process
    # the frozen tower is not in the train state: the same weights as the run
    resumed = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=4, init_params=params)
    resumed.restore_train_state(load_train_state(tmp_path / "tp_state"))
    got = {k: float(v) for k, v in resumed.train_step(batches[2], LR,
                                                      resumed._step_generator).items()}
    _losses_close(got, losses[2])
    for name, p in resumed.trainable():
        keep = first_grads[name].abs() > 1e-6 if name in first_grads else None
        if keep is not None and keep.any():
            np.testing.assert_allclose(p.detach()[keep].numpy(), final[name][keep].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=name)
        crossed = ranks[0]["from_single_params"][name]
        if keep is not None and keep.any():
            np.testing.assert_allclose(crossed[keep.numpy()], final[name][keep].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=name)
    assert torch.equal(resumed._step_generator.get_state(), single._step_generator.get_state())


def test_model_size_one_trains_as_data_parallel(corpus, tmp_path, monkeypatch):
    """(f) a grid of model size 1 at world 2, dropout on: bitwise the
    data-parallel step without a grid."""
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    cfg = cfg_dict(corpus)
    ranks = torch_dp.spawn(torch_tp.model_size_one, 2, tmp_path, cfg, model_cfg(), jax_params())
    for r in ranks:
        assert r["grid"]["scalars"] == r["plain"]["scalars"] and r["plain"]["scalars"]
        assert torch.equal(r["grid"]["rng"], r["plain"]["rng"])
        for name, value in r["plain"]["params"].items():
            assert torch.equal(r["grid"]["params"][name], value), name
    for name, value in ranks[0]["grid"]["params"].items():
        assert torch.equal(ranks[1]["grid"]["params"][name], value), name


def test_train_window_under_a_model_axis_raises(corpus, tmp_path, monkeypatch):
    """(g) steps_per_dispatch > 1 under a model axis: at dp1 x tp2 (gloo
    ranks, dropout on) the K = 2 epoch (the step graph's eager static-input
    step) is bitwise the K = 1 epoch; what raises is a graph that would
    capture under gloo, naming the backend. A runner on a model axis holds
    its shards."""
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
    cfg = cfg_dict(corpus)
    batches = list(BatchLoader(AVQADataset(Box(cfg), mode="train"), 8, prefetch=0))
    ranks = torch_dp.spawn(torch_tp.window_epochs, 2, tmp_path, cfg, model_cfg(), jax_params(),
                           batches, 2)
    for r in ranks:
        one, k = r["k1"], r["k"]
        assert k["graph"] and not one["graph"]
        assert k["scalars"] == one["scalars"] and len(one["scalars"]) == 3 * 2
        assert torch.equal(k["rng"], one["rng"])
        for name, value in one["params"].items():
            assert torch.equal(k["params"][name], value), name
        assert set(k["moments"]) == set(one["moments"]) and len(one["moments"]) > 50
        for name, (m1, v1) in one["moments"].items():
            m2, v2 = k["moments"][name]
            assert torch.equal(m1, m2) and torch.equal(v1, v2), name
        assert "gloo" in r["capture_error"]
    for name, value in ranks[0]["k"]["replicated"].items():
        assert np.array_equal(value, ranks[1]["k"]["replicated"][name]), name
    # the shards it holds: half of every split parameter
    runner = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=0,
                        grid=Grid(model_rank=0, model_size=2))
    whole = AVQARunner(Box(cfg), model_cfg(), device="cpu", seed=0)
    w = dict(whole.model.named_parameters())["crs_attn.linear1.weight"]
    got = dict(runner.model.named_parameters())["crs_attn.linear1.weight"]
    assert got.shape == (w.shape[0] // 2, w.shape[1]) and torch.equal(got, w[:w.shape[0] // 2])
