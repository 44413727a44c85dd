"""The shipped variant configs through the port's ``test`` entry point, on
the CPU: ``configs/qa-tiger/vitl14_v2.py`` (MUSIC-AVQA-v2.0: its own
42-answer vocabulary, the balanced and the biased test split),
``vitl14_avqa_r.py`` (MUSIC-AVQA-R: the head-tail split, then head and
tail) and ``demo_synth.py`` (over ``scripts/make_demo_data.py``'s corpus,
generated into a temporary directory).

Each config is used as it stands, wrapped by a file that overrides only the
data root, the batch sizes, the model's widths (a 2-layer text tower
registered as ``tiny-variants``) and ``platform='cpu'``, as
``tests/test_avqa_r.py`` does. The v2 splits are the first questions of the
real annotation files; the AVQA-R splits are synthetic in that test's
schema; features are synthetic. The port's ``test.main`` and the JAX
package's ``src/test.py`` evaluate the same ``best.npz`` (seeded weights);
for every split, in order, the report lines (per question type, per
modality, total) are equal.
"""
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu_torch import test as t_test
from qa_tiger_tpu_torch.models import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.training import save_checkpoint
from torch_corpus import write_merges

REPO = Path(__file__).resolve().parents[1]
ANNOTS = REPO / "data" / "annots"
TOWER = "tiny-variants"
T, P = 6, 4
N_QUESTIONS = 24  # of each v2 split
REPORT = re.compile(r"\]:(Test .* accuracy: .*)$")
SPLIT = re.compile(r"Testing\.\.\. (\S+)")
# the shipped feature directories (configs/qa-tiger/vitl14.py)
FEATS = ("feats/vggish", "feats/clip_feats/1fps", "feats/visual_tome14_60")
SMALL = dict(audio_dim=16, video_dim=32, patch_dim=24)
# demo_synth reads make_demo_data.py's features at the real widths
DEMO = dict(audio_dim=128, video_dim=768, patch_dim=1024)


def _features(root: Path, videos, dims: dict, rng) -> None:
    shapes = [(T, dims["audio_dim"]), (T, dims["video_dim"]), (T, P, dims["patch_dim"])]
    for rel, shape in zip(FEATS, shapes):
        (root / rel).mkdir(parents=True, exist_ok=True)
        for vid in sorted(set(videos)):
            np.save(root / rel / f"{vid}.npy", rng.standard_normal(shape, dtype=np.float32))


def v2_corpus(root: Path) -> list[dict]:
    """The first N_QUESTIONS of test_balance.json and test_bias.json, the
    v2 answer vocabulary, features for their videos."""
    src, dst = ANNOTS / "music_avqa_v2", root / "annots" / "music_avqa_v2"
    dst.mkdir(parents=True)
    questions = []
    for name in ("test_balance.json", "test_bias.json"):
        part = json.loads((src / name).read_text())[:N_QUESTIONS]
        (dst / name).write_text(json.dumps(part))
        questions += part
    shutil.copy(src / "answer2idx.json", dst / "answer2idx.json")
    _features(root, [q["video_id"] for q in questions], SMALL, np.random.default_rng(0))
    return questions


def avqa_r_corpus(root: Path) -> list[dict]:
    """Head (18) and tail (9) splits in MUSIC-AVQA-R's schema
    (tests/test_avqa_r.py), their union as head-tail, the MUSIC-AVQA answer
    vocabulary, features for their videos."""
    rng = np.random.default_rng(1)
    answers = list(json.loads((ANNOTS / "music_avqa" / "answer2idx.json").read_text())
                   ["ans2ix"])
    real = json.loads((ANNOTS / "music_avqa" / "music_avqa_val.json").read_text())

    def annots(n, offset):
        return [{**{k: real[offset + i][k] for k in ("video_id", "type", "question_content",
                                                      "templ_values")},
                 "question_id": offset * 1000 + i,
                 "anser": answers[int(rng.integers(0, len(answers)))]} for i in range(n)]

    head, tail = annots(18, 0), annots(9, 100)
    dst = root / "annots" / "music_avqa_r"
    dst.mkdir(parents=True)
    for name, part in (("head", head), ("tail", tail), ("headtail", head + tail)):
        (dst / f"avqa-test-{name}.json").write_text(json.dumps(part))
    (root / "annots" / "music_avqa").mkdir(parents=True)
    shutil.copy(ANNOTS / "music_avqa" / "answer2idx.json",
                root / "annots" / "music_avqa" / "answer2idx.json")
    _features(root, [q["video_id"] for q in head + tail], SMALL, rng)
    return head + tail


def demo_corpus(root: Path) -> list[dict]:
    """scripts/make_demo_data.py over a copy of the MUSIC-AVQA annotations:
    2 videos of T frames."""
    shutil.copytree(ANNOTS / "music_avqa", root / "annots" / "music_avqa")
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_demo_data.py"), "--root",
                    str(root), "--videos", "2", "--t", str(T)], check=True, capture_output=True)
    return [q for name in ("train", "val", "test")
            for q in json.loads((root / "annots" / "demo" / f"{name}.json").read_text())]


VARIANTS = {"vitl14_v2": (v2_corpus, SMALL, ["annots/music_avqa_v2/test_balance.json",
                                             "annots/music_avqa_v2/test_bias.json"]),
            "vitl14_avqa_r": (avqa_r_corpus, SMALL, ["annots/music_avqa_r/avqa-test-headtail.json",
                                                     "annots/music_avqa_r/avqa-test-head.json",
                                                     "annots/music_avqa_r/avqa-test-tail.json"]),
            "demo_synth": (demo_corpus, DEMO, ["annots/demo/test.json"])}


def wrap_config(path: Path, name: str, root: Path, dims: dict) -> Path:
    model = dict(d_model=32, topK=2, num_experts=4, encoder_type=TOWER, **dims)
    path.write_text(f"""
import importlib.util
_spec = importlib.util.spec_from_file_location(
    "shipped_{name}", {str(REPO / 'configs' / 'qa-tiger' / f'{name}.py')!r})
_mod = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mod)
config = _mod.config
config["data"].update(root={str(root)!r}, batch_size=8, eval_batch_size=8, num_workers=0)
config["hyper_params"]["model"].update({model!r})
config["hyper_params"]["platform"] = "cpu"
config["weight"] = ''
""")
    return path


def report(path: Path) -> list[str]:
    """The splits announced and every report line, in order."""
    out = []
    for line in path.read_text().splitlines():
        if m := SPLIT.search(line):
            out.append(m.group(1))
        elif m := REPORT.search(line.rstrip()):
            out.append(m.group(1))
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_config_report_equals_jax(name, tmp_path, monkeypatch):
    make_corpus, dims, splits = VARIANTS[name]
    root = tmp_path / "data"
    questions = make_corpus(root)
    write_merges(tmp_path / "vocab.txt.gz", [q["question_content"] for q in questions], 300)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(tmp_path / "vocab.txt.gz"))
    tower = dict(width=dims["video_dim"], heads=4, layers=2, embed_dim=dims["video_dim"])
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, TOWER, tower)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, TOWER, tower)
    cfg = wrap_config(tmp_path / f"{name}.py", name, root, dims)
    n_answers = len(json.loads(next(root.glob("annots/*/answer2idx.json")).read_text())["ans2ix"])
    model = QATiger(qa_tiger_config(num_labels=n_answers, d_model=32, topK=2, num_experts=4,
                                    encoder_type=TOWER, **dims), seed=11)
    weight = tmp_path / "best.npz"
    save_checkpoint(model.state_dict(), weight)

    accs = t_test.main(["--config", str(cfg), "--weight", str(weight), "--output_path",
                        str(tmp_path / "port")])
    spec = importlib.util.spec_from_file_location(f"qa_variants_{name}", REPO / "src" / "test.py")
    j_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_test)
    monkeypatch.setattr(sys, "argv", ["test.py", "--config", str(cfg), "--weight", str(weight),
                                      "--output_path", str(tmp_path / "jax")])
    j_test.main()

    got = report(tmp_path / "port" / "best_result.txt")
    want = report(tmp_path / "jax" / "best_result.txt")
    assert got == want
    assert len(accs) == len(splits)
    # the first split is test_annot (reported, not announced); then each of
    # test_annots is announced and reported: 13 lines per split
    assert [x for x in got if not x.startswith("Test")] == splits[1:]
    assert len([x for x in got if x.startswith("Test")]) == 13 * len(splits)
    totals = [x for x in got if "Total avg" in x]
    assert [re.search(r"accuracy: ([\d.]+)\(", x).group(1) for x in totals] == \
        [f"{a:.2f}" for a in accs]
