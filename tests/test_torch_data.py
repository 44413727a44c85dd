"""The port's data layer against the JAX package's, on the CPU: annotations,
question types, template filling and QA prompts on every question of
music_avqa_val.json; ``AVQADataset`` items and ``BatchLoader`` batches over
a synthetic corpus of real questions (tokenizer and ``quest_feat`` modes,
per-epoch shuffle, strided shards, the padded tail, ``frame_sample_rate``,
the native and the per-sample paths, consolidated shards); the native .npy
reader against numpy. Every comparison is exact."""
import json
from pathlib import Path

import numpy as np
import pytest

from qa_tiger_tpu.data import annotations as j_ann
from qa_tiger_tpu.data import dataset as j_ds
from qa_tiger_tpu.data import prompts as j_prompts
from qa_tiger_tpu.pipeline import consolidate as j_cons
from qa_tiger_tpu.utils import Box as JBox
from qa_tiger_tpu_torch.data import annotations as t_ann
from qa_tiger_tpu_torch.data import dataset as t_ds
from qa_tiger_tpu_torch.data import native_loader
from qa_tiger_tpu_torch.data import prompts as t_prompts
from qa_tiger_tpu_torch.pipeline import consolidate as t_cons
from qa_tiger_tpu_torch.utils import Box as TBox
from torch_corpus import VAL_JSON, val_questions, write_corpus, write_merges

REPO = Path(__file__).resolve().parents[1]
T, P = 6, 4
DIMS = {"vggish": (T, 16), "clip": (T, 32), "tome": (T, P, 24)}
N_TRAIN = 19


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_corpus(root, {"train": (0, N_TRAIN)}, DIMS)
    rng = np.random.default_rng(1)
    for sub, shape in (("quest", (77, 32)), ("prompt", (32,))):
        (root / sub).mkdir()
        for q in val_questions()[:N_TRAIN]:
            np.save(root / sub / f"{q['question_id']}.npy",
                    rng.standard_normal(shape, dtype=np.float32))
    for sub in DIMS:  # the same features as consolidated shards
        j_cons.consolidate(root / sub, root / f"{sub}_shard")
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 200)
    return root


@pytest.fixture(autouse=True)
def _vocab(corpus, monkeypatch):
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))


def data_cfg(root, **over) -> dict:
    data = dict(root=str(root), frame_sample_rate=1, train_annot="train.json",
                ans_quelen="answer2idx.json", audio_feat="vggish", video_feat="clip",
                patch_feat="tome", quest_feat=None, prompt_feat=None)
    data.update(over)
    return {"type": "qa-tiger", "data": data}


def both(cfg: dict):
    """(port dataset, JAX dataset) from one config."""
    return (t_ds.AVQADataset(TBox(cfg), "train"), j_ds.AVQADataset(JBox(cfg), "train"))


def assert_batches_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            assert np.array_equal(g[key], w[key]), key


# --- annotations and prompts -------------------------------------------------

def test_question_types_tables_and_vocab():
    assert t_ann.qtype2idx == j_ann.qtype2idx
    assert [tuple(x) for x in t_ann.idx2qtype] == [tuple(x) for x in j_ann.idx2qtype]
    assert t_ann.NUM_QTYPES == j_ann.NUM_QTYPES
    assert t_ann.load_annotations(VAL_JSON) == j_ann.load_annotations(VAL_JSON)
    vocab = VAL_JSON.parent / "answer2idx.json"
    assert t_ann.load_answer_vocab(vocab) == j_ann.load_answer_vocab(vocab)
    from qa_tiger_tpu_torch.training import metrics

    assert metrics.idx2qtype is t_ann.idx2qtype  # one table in the port


def test_every_val_question_type_template_and_prompt():
    qs = val_questions()
    for q in qs:
        assert t_ann.qtype_index(q["type"]) == j_ann.qtype_index(q["type"])
        assert (t_ann.substitute_template(q["question_content"], q["templ_values"])
                == j_ann.substitute_template(q["question_content"], q["templ_values"]))
        assert (t_prompts.match_prompt(q["question_content"], q["templ_values"])
                == j_prompts.match_prompt(q["question_content"], q["templ_values"]))
    assert len({t_ann.qtype_index(q["type"]) for q in qs}) == 9


def test_prompt_table_and_its_two_quirks():
    assert t_prompts.PROMPT_TABLE == j_prompts.PROMPT_TABLE and len(t_prompts.PROMPT_TABLE) == 33
    assert t_prompts.match_prompt("Unknown question?", "[]") == "e"
    q = "Is there a <Object> in the entire video?"
    assert t_prompts.match_prompt(q, '["acoustic guitar"]') == \
        j_prompts.match_prompt(q, '["acoustic guitar"]') == "The acousticguitar is not in this video."
    for values in ('["a", "b"]', '[" x y ", "z"]', "[]"):
        assert t_prompts.clean_templ_values(values) == j_prompts.clean_templ_values(values)


# --- the dataset and its loader -----------------------------------------------

@pytest.mark.parametrize("mode", ["tokens", "quest_feat", "quest_prompt_feat"])
@pytest.mark.parametrize("native", [True, False])
def test_items_equal_jax(corpus, mode, native):
    over = {"native_loader": native}
    if mode != "tokens":
        over["quest_feat"] = "quest"
    if mode == "quest_prompt_feat":
        over["prompt_feat"] = "prompt"
    port, jax_ = both(data_cfg(corpus, **over))
    assert port.use_native == jax_.use_native == native
    assert (port.tokenizer is None) == (jax_.tokenizer is None) == (mode != "tokens")
    assert len(port) == len(jax_) == N_TRAIN
    for i in range(N_TRAIN):
        a, b = port[i], jax_[i]
        assert set(a) == set(b)
        for key in b:
            assert np.array_equal(a[key], b[key]) and np.asarray(a[key]).dtype == \
                np.asarray(b[key]).dtype, (i, key)


@pytest.mark.parametrize("mode", ["tokens", "quest_prompt_feat"])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle,epoch,shard,shards,batch", [
    (False, 0, 0, 1, 8),   # padded tail: 19 = 8 + 8 + 3
    (True, 0, 0, 1, 8),
    (True, 3, 0, 1, 5),    # another epoch, another order
    (True, 1, 1, 2, 4),    # the second of two strided shards
    (False, 0, 2, 3, 4),
])
def test_batches_equal_jax(corpus, mode, native, shuffle, epoch, shard, shards, batch):
    over = {"native_loader": native}
    if mode != "tokens":
        over.update(quest_feat="quest", prompt_feat="prompt")
    port, jax_ = both(data_cfg(corpus, **over))
    loaders = []
    for ds, cls in ((port, t_ds.BatchLoader), (jax_, j_ds.BatchLoader)):
        loader = cls(ds, batch, shuffle=shuffle, seed=7, shard_id=shard, num_shards=shards)
        loader.set_epoch(epoch)
        loaders.append(loader)
    got, want = list(loaders[0]), list(loaders[1])
    assert len(loaders[0]) == len(loaders[1]) == len(got)
    assert_batches_equal(got, want)
    rows = np.concatenate([b["ds_idx"][b["valid"]] for b in got])
    assert len(rows) == len(set(rows.tolist())) == len(range(shard, N_TRAIN, shards))
    assert all(b["quest"].shape[0] == batch for b in got)


def test_native_path_reads_natively(corpus):
    port, _ = both(data_cfg(corpus))
    assert port.use_native and native_loader.native_available()
    native_loader.reset_counts()
    batches = list(t_ds.BatchLoader(port, 8, prefetch=0))
    assert native_loader.counts == {"native": 3 * 3 * 8, "numpy": 0}
    assert batches[-1]["valid"].sum() == N_TRAIN - 16


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_missing_feature_file_raises(native, prefetch, tmp_path):
    """A feature file missing from the last batch raises from the loader
    after the batches before it, on either path, with or without the
    prefetch thread: no early end of the epoch."""
    write_corpus(tmp_path, {"train": (0, N_TRAIN)}, DIMS)
    (tmp_path / "clip" / f"{val_questions()[N_TRAIN - 1]['video_id']}.npy").unlink()
    port, _ = both(data_cfg(tmp_path, native_loader=native))
    got = []
    with pytest.raises(FileNotFoundError):
        for batch in t_ds.BatchLoader(port, 8, prefetch=prefetch):
            got.append(batch)
    assert len(got) == 2


def test_epoch_shuffle_varies_and_repeats(corpus):
    port, _ = both(data_cfg(corpus))
    loader = t_ds.BatchLoader(port, N_TRAIN, shuffle=True, seed=5)
    first = next(iter(loader))["ds_idx"]
    assert np.array_equal(first, next(iter(loader))["ds_idx"])
    loader.set_epoch(1)
    assert not np.array_equal(first, next(iter(loader))["ds_idx"])


@pytest.mark.parametrize("rate", [2, 3])
def test_frame_sample_rate(corpus, rate):
    """Visual streams subsampled, audio not; the native path is ineligible."""
    port, jax_ = both(data_cfg(corpus, frame_sample_rate=rate))
    assert not port.use_native and not jax_.use_native
    assert port[0]["video"].shape == (len(range(0, T, rate)), 32)
    assert port[0]["audio"].shape == (T, 16)
    assert_batches_equal(list(t_ds.BatchLoader(port, 8)), list(j_ds.BatchLoader(jax_, 8)))
    cfg = data_cfg(corpus, frame_sample_rate=rate)
    vid = val_questions()[0]["video_id"]
    got = t_ds.load_video_features(TBox(cfg).data, vid)
    want = j_ds.load_video_features(JBox(cfg).data, vid)
    assert set(got) == set(want) == {"audio", "video", "patch"}
    for key in want:
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("native", [True, False])
def test_consolidated_shards(corpus, native, tmp_path):
    """Shards packed by either package read the same; batches from shards
    equal batches from the per-video files."""
    t_cons.consolidate(corpus / "clip", tmp_path / "clip_shard")
    assert np.array_equal(np.load(tmp_path / "clip_shard" / "features.npy"),
                          np.load(corpus / "clip_shard" / "features.npy"))
    assert (json.loads((tmp_path / "clip_shard" / "index.json").read_text())
            == json.loads((corpus / "clip_shard" / "index.json").read_text()))
    reader = t_cons.ShardReader(corpus / "clip_shard")
    assert t_cons.open_if_shard(corpus / "clip") is None
    assert reader.item_shape == (T, 32)
    sharded = data_cfg(corpus, audio_feat="vggish_shard", video_feat="clip_shard",
                       patch_feat="tome_shard", native_loader=native)
    port, jax_ = both(sharded)
    assert all(v is not None for v in port.shards.values())
    got = list(t_ds.BatchLoader(port, 8, shuffle=True, seed=2))
    assert_batches_equal(got, list(j_ds.BatchLoader(jax_, 8, shuffle=True, seed=2)))
    plain, _ = both(data_cfg(corpus, native_loader=native))
    want = list(t_ds.BatchLoader(plain, 8, shuffle=True, seed=2))
    for g, w in zip(got, want):
        for key in ("audio", "video", "patch", "quest", "label"):
            assert np.array_equal(g[key], w[key]), key


# --- the native .npy reader ----------------------------------------------------

@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal((10, 16), dtype=np.float32) for _ in range(6)]
    for i, arr in enumerate(arrays):
        np.save(d / f"f{i}.npy", arr)
    return d, arrays


def test_native_library_builds_outside_the_package():
    assert native_loader.native_available()
    assert native_loader._lib is not None
    built = list((REPO / "build" / "native").glob(f"*/{native_loader.LIB_NAME}"))
    assert built, "the library is not under build/native/"
    pkg = REPO / "qa_tiger_tpu_torch" / "data"
    assert not [p for p in pkg.rglob("*") if p.suffix in (".so", ".o")]


def test_load_npy_batch_matches_numpy(npy_dir):
    d, arrays = npy_dir
    native_loader.reset_counts()
    out = native_loader.load_npy_batch([d / f"f{i}.npy" for i in range(6)], (10, 16))
    assert np.array_equal(out, np.stack(arrays))
    assert native_loader.counts == {"native": 6, "numpy": 0}


def test_load_npy_batch_prefix_truncation(npy_dir):
    d, arrays = npy_dir
    out = native_loader.load_npy_batch([d / "f0.npy", d / "f1.npy"], (4, 16))
    assert np.array_equal(out, np.stack([arrays[0][:4], arrays[1][:4]]))


def test_load_npy_batch_numpy_fallback(npy_dir, tmp_path):
    """A float64 file and a Fortran-order one are read by numpy, the float32
    C-order ones beside them by the library."""
    d, arrays = npy_dir
    f64 = np.arange(160, dtype=np.float64).reshape(10, 16)
    np.save(tmp_path / "d.npy", f64)
    np.save(tmp_path / "f.npy", np.asfortranarray(arrays[2]))
    native_loader.reset_counts()
    out = native_loader.load_npy_batch([d / "f0.npy", tmp_path / "d.npy", tmp_path / "f.npy"],
                                       (10, 16))
    assert np.array_equal(out, np.stack([arrays[0], f64.astype(np.float32), arrays[2]]))
    assert native_loader.counts == {"native": 1, "numpy": 2}
