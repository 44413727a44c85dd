"""The port's train epoch on a dp2 x tp2 grid against the JAX runner on its
dp2 x tp2 CPU mesh (``make_mesh(4, model_parallel=2)``, the mesh of
``tests/test_training.py:436``), on the CPU.

Four spawned gloo ranks (``tests/torch_dp.py``; ``parallel.make_grid(2)``)
run ``train_epoch`` over the train split (19 questions: 3 steps of 8, each
data rank's shard 4 rows, the last a tail batch) at a tiny config, fp32,
``gather_mode="paper"``, dropout off (``DROPOUT_OFF`` at the train
kernels' sites, whose masks are then all ones; the attention-dropout sites
at 0), with ``grad_accum`` 1 and 2. The logged losses match the JAX
runner's within rtol 1e-5; the trainable parameters after the epoch,
gathered whole, within rtol 2e-4 / atol 2e-5 (the JAX ``grad_accum``
test's tolerance) where the last gradient is above 1e-6 (Adam turns a
structurally zero gradient's rounding noise into steps of either sign);
the model ranks of a data rank hold bitwise equal replicated parameters,
and the two data ranks bitwise equal gathered ones.
"""
import jax
import numpy as np
import pytest

import torch_dp
import torch_tp
from qa_tiger_tpu.data import AVQADataset as JDataset
from qa_tiger_tpu.data import BatchLoader as JBatchLoader
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import FROZEN_PREFIXES as J_FROZEN
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_forward, qa_tiger_init
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training.loop import AVQARunner as JAXRunner
from qa_tiger_tpu.utils import Box as JBox
from qa_tiger_tpu_torch.convert import nested_to_flat
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.models import qa_tiger_config
from torch_corpus import val_questions, write_corpus, write_merges

TINY = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
            encoder_type="tiny-test")
DIMS = {"vggish": (12, 16), "clip": (12, 32), "tome": (12, 4, 24)}
SPLITS = {"train": (0, 19), "val": (19, 35), "test": (35, 52)}
LR = 1e-3
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
# dropout "off" with the train kernels' masked path on: keep rounds to 1.0
DROPOUT_OFF = 1e-300


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_mesh")
    write_corpus(root / "data", SPLITS, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    return root


@pytest.fixture(autouse=True)
def _tiny(corpus, monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", torch_dp.TINY_TOWER)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))


def cfg_dict(corpus, grad_accum: int) -> dict:
    return dict(
        type="qa-tiger", mode="train", debug=False, log_interval=100, epochs=1, seed=7,
        num_labels=42,
        data=dict(root=str(corpus / "data"), frame_sample_rate=1, batch_size=8,
                  eval_batch_size=8, train_annot="train.json", valid_annot="val.json",
                  test_annot="test.json", ans_quelen="answer2idx.json", audio_feat="vggish",
                  video_feat="clip", patch_feat="tome", quest_feat=None, prompt_feat=None),
        hyper_params=dict(
            model=dict(TINY),
            optim=dict(lr=LR, betas=(0.95, 0.999), weight_decay=0, encoder_lr=None,
                       grad_accum=grad_accum),
            sched=dict(name="StepLR", step_size=8, gamma=0.1, mode="min", factor=0.5,
                       patience=5)))


def jax_epoch(cfg, params):
    """The JAX runner's epoch on its dp2 x tp2 mesh, dropout off: the logged
    losses and the trainable parameters, flat."""
    def forward(p, batch, mcfg, train=False, rng=None):  # dropout off
        return qa_tiger_forward(p, batch, mcfg, train=train, rng=None)

    runner = JAXRunner(JBox(cfg), j_config(num_labels=42, gather_mode="paper", **TINY),
                       qa_tiger_init, forward, J_FROZEN,
                       mesh=make_mesh(4, model_parallel=2, devices=jax.devices("cpu")),
                       seed=0, init_params=params)
    assert dict(runner.mesh.shape) == {"data": 2, "model": 2}
    writer = torch_dp.Writer()
    loader = JBatchLoader(JDataset(JBox(cfg), mode="train"), 8, shuffle=True, seed=cfg["seed"])
    runner.train_epoch(1, loader, lr=LR, writer=writer)
    return writer.scalars, nested_to_flat(jax.tree_util.tree_map(np.asarray, runner.trainable))


@pytest.mark.parametrize("accum", [1, 2])
def test_dp2_tp2_train_matches_the_jax_mesh(corpus, tmp_path, accum):
    cfg = cfg_dict(corpus, accum)
    params = jax.tree_util.tree_map(np.asarray, qa_tiger_init(
        jax.random.PRNGKey(0), j_config(num_labels=42, gather_mode="paper", **TINY)))
    mcfg = {**qa_tiger_config(num_labels=42, gather_mode="paper", **TINY),
            "dropout": DROPOUT_OFF}
    ranks = torch_dp.spawn(torch_tp.train_epoch, 4, tmp_path, cfg, mcfg, params, 2)
    j_scalars, want = jax_epoch(cfg, params)

    assert [r["grid"] for r in ranks] == [(g // 2, 2, g % 2, 2) for g in range(4)]
    r0 = ranks[0]
    assert r0["steps"] == 3
    assert [(t, s) for t, s, _ in r0["scalars"]] == [(t, s) for t, s, _ in j_scalars]
    np.testing.assert_allclose([v for *_, v in r0["scalars"]], [v for *_, v in j_scalars],
                               **LOSS_TOL)
    for r in ranks[1:]:
        assert r["scalars"] == r0["scalars"]
        for name, value in r0["params"].items():  # gathered: whole on every rank
            assert np.array_equal(r["params"][name], value), name
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        assert len(a["replicated"]) > 20
        for name, value in a["replicated"].items():
            assert np.array_equal(b["replicated"][name], value), name
    assert set(r0["params"]) == set(want)
    compared = 0
    for name, value in r0["params"].items():
        keep = np.abs(r0["grads"].get(name, np.zeros_like(value))) > 1e-6
        if keep.any():
            np.testing.assert_allclose(value[keep], want[name][keep], err_msg=name, **PARAM_TOL)
            compared += 1
    assert compared > 50
