"""``python -m qa_tiger_tpu_torch.train|test`` on the CPU at a tiny config
(``platform='cpu'``, a 2-layer text tower registered as ``tiny-test``),
over real MUSIC-AVQA questions with synthetic features and a merges file
the test writes; the JAX package's ``src/test.py`` on the port's
``best.npz``; the command line's config, the parameter report and the
``.pt`` export against the JAX package's."""
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.convert.torch_import import load_torch_checkpoint as j_load_pt
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_init
from qa_tiger_tpu.utils import arg_parse as j_arg_parse
from qa_tiger_tpu.utils import build_config as j_build_config
from qa_tiger_tpu.utils import calculate_parameters as j_calculate_parameters
from qa_tiger_tpu_torch import test as t_test
from qa_tiger_tpu_torch import train as t_train
from qa_tiger_tpu_torch.convert import nested_to_flat, save_torch_checkpoint
from qa_tiger_tpu_torch.models import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.utils import arg_parse, build_config, calculate_parameters
from torch_corpus import val_questions, write_config, write_corpus, write_merges

REPO = Path(__file__).resolve().parents[1]
TINY_TOWER = dict(width=32, heads=4, layers=2, embed_dim=32)
MODEL = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
             encoder_type="tiny-test")
DIMS = {"vggish": (12, 16), "clip": (12, 32), "tome": (12, 4, 24)}
SPLITS = {"train": (0, 40), "val": (40, 56), "test": (56, 72)}
REPORT = re.compile(r"\]:(Test .* accuracy: .*)$")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_corpus(root / "data", SPLITS, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    return root


@pytest.fixture(autouse=True)
def _tiny(corpus, monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))


def config(corpus, name, **top):
    top.setdefault("platform", "cpu")
    return write_config(corpus / f"{name}.py", corpus / "data", corpus / f"out_{name}", MODEL,
                        **top)


def report_lines(path: Path) -> list[str]:
    """The final test's per-qtype lines of a log, without their prefixes."""
    return [m.group(1) for line in path.read_text().splitlines()
            if (m := REPORT.search(line.rstrip()))]


@pytest.fixture(scope="module")
def trained(corpus):
    """One epoch of train (lr 1e-2, so that the answers vary), then test on
    its best.npz."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-test", TINY_TOWER)
        mp.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
        cfg = config(corpus, "train")
        text = cfg.read_text().replace("'lr': 0.001", "'lr': 0.01")
        cfg.write_text(text)
        summary = t_train.main(["--config", str(cfg)])
        run = Path(summary["run_dir"])
        accs = t_test.main(["--config", str(cfg), "--weight", str(run / "best.npz"),
                            "--output_path", str(corpus / "eval_port")])
    return cfg, summary, run, accs


def test_train_then_test(trained, corpus):
    _, summary, run, accs = trained
    assert summary["start_epoch"] == 1 and [e["epoch"] for e in summary["epochs"]] == [1]
    assert summary["epochs"][0]["steps"] == 5  # 40 questions, batch 8
    for name in ("best.npz", "log.txt", "code_snapshot.zip", "last_state/state.pt",
                 "last_state/meta.json"):
        assert (run / name).exists(), name
    result = corpus / "eval_port" / "best_result.txt"
    assert result.exists()
    train_lines, test_lines = report_lines(run / "log.txt"), report_lines(result)
    assert len(test_lines) == 13 and test_lines[-1].startswith("Test                Total avg")
    assert train_lines == test_lines  # the same weights and batches: the same counts
    assert accs == summary["tests"]
    assert test_lines[-1].endswith("/16)")
    with np.load(run / "best.npz") as data:
        assert not any(k.startswith("video_encoder") for k in data.files)
        assert any(k.startswith("quest_encoder") for k in data.files)


def test_resume_starts_at_the_next_epoch_and_carries_best(trained, corpus):
    _, _, run, _ = trained
    cfg = config(corpus, "resume", epochs=2, cache_qst_features=True,
                 resume=str(run / "last_state"))
    summary = t_train.main(["--config", str(cfg)])
    new_run = Path(summary["run_dir"])
    assert summary["start_epoch"] == 2 and [e["epoch"] for e in summary["epochs"]] == [2]
    assert summary["carried_over"] == str(run / "best.npz")
    assert (new_run / "best.npz").exists() and (new_run / "last_state" / "state.pt").exists()
    assert summary["question_caches"] == 3  # train, val, test
    assert json.loads((new_run / "last_state" / "meta.json").read_text())["epoch"] == 2
    assert "resumed from" in (new_run / "log.txt").read_text()


def test_jax_test_entry_prints_the_port_report(trained, corpus, monkeypatch):
    """src/test.py of the JAX package on the port's best.npz, the same
    corpus and vocab: the same per-qtype report lines."""
    cfg, _, run, _ = trained
    spec = importlib.util.spec_from_file_location("qa_cli_test_entry", REPO / "src" / "test.py")
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    out = corpus / "eval_jax"
    monkeypatch.setattr(sys, "argv", ["test.py", "--config", str(cfg), "--mode", "test",
                                      "--weight", str(run / "best.npz"), "--output_path",
                                      str(out)])
    entry.main()
    want = report_lines(corpus / "eval_port" / "best_result.txt")
    assert report_lines(out / "best_result.txt") == want


@pytest.mark.parametrize("argv", [
    [],
    ["--mode", "test", "--weight", "w.npz", "--output_path", "o"],
    ["--mode", "test"],
    ["--weight", "w.npz"],
    ["--topK", "3", "--n_experts", "5", "--seed", "11", "--debug"],
    ["--topK", "0", "--n_experts", "-2"],
], ids=["defaults", "test_weight", "test_no_weight", "train_weight", "overrides", "nonpositive"])
def test_config_from_the_command_line_matches_jax(argv):
    path = str(REPO / "configs" / "qa-tiger" / "vitl14.py")
    argv = ["--config", path, *argv]
    t_args, j_args = arg_parse(argv), j_arg_parse(argv)
    assert vars(t_args) == vars(j_args)
    got, want = build_config(t_args), j_build_config(j_args)
    assert got.to_dict() == want.to_dict()
    assert got.hyper_params.model.topK == want.hyper_params.model.topK
    assert isinstance(got, dict) and got["hyper_params"]["model"] == got.hyper_params.model


def test_calculate_parameters_matches_jax(caplog):
    params = jax.tree_util.tree_map(np.asarray, qa_tiger_init(
        jax.random.PRNGKey(0), j_config(num_labels=42, **MODEL)))
    model = QATiger(qa_tiger_config(num_labels=42, **MODEL))
    with caplog.at_level("INFO", logger="AVQA"):
        j_calculate_parameters(params, frozen_prefixes=("quest_encoder",))
        want = [r.getMessage() for r in caplog.records]
        caplog.clear()
        counts = calculate_parameters(model, frozen_prefixes=("quest_encoder",))
        got = [r.getMessage() for r in caplog.records]
    assert got == want and len(want) == 6
    flat = nested_to_flat(params)
    assert counts["total"] == sum(v.size for v in flat.values())
    assert counts["tunable_names"] == json.loads(want[-1])
    assert calculate_parameters(model.state_dict(), ("quest_encoder",)) == counts


def test_save_torch_checkpoint_round_trips_through_jax(tmp_path):
    """A state with a bf16 tower and a video tower: the JAX reader gets
    every other name, fp32, with equal values; a nested numpy pytree
    writes the same file."""
    model = QATiger(qa_tiger_config(num_labels=42, **MODEL))
    model.quest_encoder.to(torch.bfloat16)
    state = {**model.state_dict(), "video_encoder.proj.weight": torch.ones(3, 2)}
    save_torch_checkpoint(state, tmp_path / "p.pt", exclude_prefixes=("video_encoder",))
    back = nested_to_flat(j_load_pt(str(tmp_path / "p.pt")))
    assert set(back) == set(state) - {"video_encoder.proj.weight"}
    for key, value in back.items():
        assert np.array_equal(value, state[key].float().numpy()), key
    nested = j_load_pt(str(tmp_path / "p.pt"))
    save_torch_checkpoint(nested, tmp_path / "q.pt")
    again = torch.load(tmp_path / "q.pt", weights_only=True)
    assert set(again) == set(back)
    for key, value in back.items():  # 0-d values stay 0-d (the JAX writer makes them 1-d)
        assert again[key].shape == value.shape and np.array_equal(again[key].numpy(), value), key


def test_without_a_card_the_entry_points_raise(corpus, monkeypatch):
    """No platform and no CUDA device: both entry points raise before any
    run directory exists; an unknown platform raises, and so does
    --distributed outside torchrun (no RANK, WORLD_SIZE, ... to join)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    cfg = config(corpus, "nocard", platform=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--config", str(cfg)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_test.main(["--config", str(cfg), "--weight", "w.npz"])
    assert not (corpus / "out_nocard").exists()
    with pytest.raises(ValueError, match="platform"):
        t_train.main(["--config", str(config(corpus, "tpu", platform="tpu"))])
    with pytest.raises(RuntimeError, match="--distributed needs the environment torchrun sets"):
        t_train.main(["--config", str(cfg), "--distributed"])
