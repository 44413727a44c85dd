"""Feature dataset and fixed-shape batch loader.

This package's own copy of ``qa_tiger_tpu/data/dataset.py`` (the
reference's ``AVQA_dataset`` + ``DataLoader``, src/dataset.py:34-228,
src/trainutils.py:185-220):

- each sample reads cached ``.npy`` features (audio [T,128] VGGish, video
  [T,768] CLIP, patch [T,14,1024] ToMe) by video_id, and either tokenizes
  the question online (the raw templated text, placeholders left in: the
  trained checkpoints expect this, src/dataset.py:128) or reads
  precomputed question/prompt features by question_id;
- batches have a FIXED batch size: the tail batch is padded and carries a
  ``valid`` mask and the dataset rows ``ds_idx``, so every step sees one
  shape (the loss and the metrics mask out the padding);
- a background prefetch thread reads ahead of the step (``np.load`` and the
  native loader release the GIL during file reads); an in-memory feature
  cache is optional for small corpora;
- shuffling uses a per-epoch ``np.random.Generator`` seeded from
  (seed, epoch), so strided shards stay disjoint and reproducible.

Batches are numpy arrays; ``AVQARunner`` moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from qa_tiger_tpu_torch.data.annotations import (
    load_annotations,
    load_answer_vocab,
    qtype_index,
)
from qa_tiger_tpu_torch.data.native_loader import load_npy_batch
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
from qa_tiger_tpu_torch.pipeline.consolidate import open_if_shard


def _resolve(root: Path, rel: str | None) -> Path | None:
    if rel is None:
        return None
    p = Path(rel)
    return p if p.is_absolute() else root / p


def load_video_features(cfg_data, video_id: str,
                        repo_root: Path | None = None
                        ) -> dict[str, np.ndarray]:
    """One video's cached feature arrays ({audio, video, patch} as present),
    with the config's root resolution and ``frame_sample_rate`` subsampling
    of the visual streams — the single loading contract shared by the
    serving surfaces (src/predict.py, src/serve.py) and this dataset
    (reference per-sample path: src/dataset.py:134-159)."""
    root = Path(cfg_data.root)
    if not root.is_absolute() and repo_root is not None:
        root = Path(repo_root) / root
    sr = int(cfg_data.get("frame_sample_rate", 1) or 1)
    out: dict[str, np.ndarray] = {}
    for key, sub in (("audio", cfg_data.audio_feat),
                     ("video", cfg_data.video_feat),
                     ("patch", cfg_data.get("patch_feat"))):
        if not sub:
            continue
        arr = np.load(_resolve(root, sub) / f"{video_id}.npy")
        arr = arr.astype(np.float32)
        if key in ("video", "patch"):
            arr = arr[::sr]
        out[key] = arr
    return out


class AVQADataset:
    """Sample-level access to an annotation split + cached feature dirs."""

    def __init__(self, cfg, mode: str, repo_root: Path | None = None):
        self.mode = mode
        self.cfg = cfg
        root = Path(repo_root) if repo_root is not None else Path.cwd()
        data_root = _resolve(root, cfg.data.root)

        self.audio_feat = _resolve(data_root, cfg.data.get("audio_feat"))
        self.video_feat = _resolve(data_root, cfg.data.get("video_feat"))
        self.patch_feat = _resolve(data_root, cfg.data.get("patch_feat"))
        self.quest_feat = _resolve(data_root, cfg.data.get("quest_feat"))
        self.prompt_feat = _resolve(data_root, cfg.data.get("prompt_feat"))
        self.sample_rate = int(cfg.data.get("frame_sample_rate", 1))

        annot_rel = cfg.data.get(f"{mode}_annot")
        if annot_rel is None:
            raise KeyError(f"config has no data.{mode}_annot")
        self.samples: list[dict] = load_annotations(_resolve(data_root, annot_rel))

        self.answer_to_ix, self.max_que_len = load_answer_vocab(
            _resolve(data_root, cfg.data.ans_quelen))
        cfg.num_labels = len(self.answer_to_ix)

        self.tokenizer = ClipTokenizer() if self.quest_feat is None else None
        self.cache: dict[str, np.ndarray] = {}
        self.cache_features = bool(cfg.data.get("cache_features", False))
        # consolidated memmap shards (pipeline/consolidate.py) are detected
        # per modality and served by fancy-indexed batch gathers
        self.shards = {
            key: open_if_shard(path)
            for key, path in (("audio", self.audio_feat),
                              ("video", self.video_feat),
                              ("patch", self.patch_feat))
        }
        # native C++ batch reader (qa_tiger_tpu/data/native): eligible when
        # features are read whole (frame_sample_rate == 1) and not cached
        self.use_native = (bool(cfg.data.get("native_loader", True))
                           and self.sample_rate == 1
                           and not self.cache_features)
        self._feature_shapes: dict[str, tuple] | None = None

    def feature_shapes(self) -> dict[str, tuple]:
        """Per-modality item shapes, probed once from the first sample."""
        if self._feature_shapes is None:
            name = self.samples[0]["video_id"]
            shapes = {}
            for key, base in (("audio", self.audio_feat),
                              ("video", self.video_feat),
                              ("patch", self.patch_feat)):
                if base is None:
                    continue
                shard = self.shards.get(key)
                if shard is not None:
                    shapes[key] = shard.item_shape
                else:
                    shapes[key] = np.load(base / f"{name}.npy",
                                          mmap_mode="r").shape
            self._feature_shapes = shapes
        return self._feature_shapes

    def _feature(self, key: str, base: Path, name: str) -> np.ndarray:
        shard = self.shards.get(key)
        if shard is not None:
            return shard.get(name)
        return self._load_npy(base, name)

    def load_feature_batch(self, names) -> dict[str, np.ndarray]:
        """Batch-read audio/video/patch features for ``names``: consolidated
        shards via one memmap gather, else the native C++ loader (numpy
        fallback inside)."""
        out = {}
        shapes = None
        for key, base in (("audio", self.audio_feat),
                          ("video", self.video_feat),
                          ("patch", self.patch_feat)):
            if base is None:
                continue
            shard = self.shards.get(key)
            if shard is not None:
                out[key] = shard.get_batch(names).astype(np.float32)
            else:
                if shapes is None:
                    shapes = self.feature_shapes()
                paths = [base / f"{n}.npy" for n in names]
                out[key] = load_npy_batch(paths, shapes[key])
        return out

    def __len__(self) -> int:
        return len(self.samples)

    def _load_npy(self, base: Path, name: str) -> np.ndarray:
        key = f"{base}/{name}"
        if self.cache_features and key in self.cache:
            return self.cache[key]
        arr = np.load(base / f"{name}.npy")
        if self.cache_features:
            self.cache[key] = arr
        return arr

    def __getitem__(self, index: int) -> dict:
        sample = self.samples[index]
        name = sample["video_id"]
        item: dict = {
            "label": np.int32(self.answer_to_ix[sample["anser"]]),
            "qtype_label": np.int32(qtype_index(sample["type"])),
            "name": name,
            "qid": np.int64(sample.get("question_id", -1)),
        }

        if self.quest_feat is not None:
            qid = int(sample["question_id"])
            item["quest"] = self._load_npy(self.quest_feat, str(qid)).astype(np.float32)
            if self.prompt_feat is not None:
                item["prompt"] = self._load_npy(
                    self.prompt_feat, str(qid)).astype(np.float32)
        else:
            # raw templated text, placeholders intentionally NOT substituted
            item["quest"] = self.tokenizer(
                sample["question_content"], truncate=True)[0]

        video = self._feature("video", self.video_feat, name)[:: self.sample_rate]
        item["video"] = video.astype(np.float32)
        if self.patch_feat is not None:
            patch = self._feature("patch", self.patch_feat, name)[:: self.sample_rate]
            item["patch"] = patch.astype(np.float32)
        audio = self._feature("audio", self.audio_feat, name)
        item["audio"] = audio.astype(np.float32)
        return item


class BatchLoader:
    """Fixed-shape, masked, prefetching batch iterator.

    Every batch is a dict of numpy arrays with leading dim ``batch_size``;
    ``valid`` marks real samples (False = padding replicated from sample 0 of
    the batch). ``drop_remainder=False`` pads the tail batch instead of
    shrinking it, keeping jit shapes static.

    Multi-host: pass (shard_id, num_shards) to iterate a disjoint strided
    shard of the dataset (the DistributedSampler equivalent,
    src/trainutils.py:191-198). Every shard counts the batches of the
    largest, ``ceil(ceil(n / num_shards) / batch_size)``, so that every rank
    takes the same number of steps (and reaches every collective): a shard
    that runs out first yields batches of padding, ``valid`` all False.
    """

    def __init__(self, dataset: AVQADataset, batch_size: int, *,
                 shuffle: bool = False, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(order)
        return order[self.shard_id:: self.num_shards]

    def __len__(self) -> int:
        per_shard = -(-len(self.dataset) // self.num_shards)
        return -(-per_shard // self.batch_size)

    def _make_batch(self, idxs: np.ndarray) -> dict[str, np.ndarray]:
        """The batch of dataset rows ``idxs``, padded to ``batch_size`` with
        its first row, or with the dataset's row 0 when ``idxs`` is empty."""
        ds = self.dataset
        fill = int(idxs[0]) if len(idxs) else 0
        native = getattr(ds, "use_native", False)
        if native:
            # metadata per sample in python; features via one native batched
            # read per modality straight into the batch buffers
            samples = [ds.samples[int(i)] for i in idxs]
            n_pad = self.batch_size - len(samples)
            if n_pad:
                samples.extend([ds.samples[fill]] * n_pad)
            names = [s["video_id"] for s in samples]
            batch: dict[str, np.ndarray] = dict(ds.load_feature_batch(names))
            batch["label"] = np.array(
                [ds.answer_to_ix[s["anser"]] for s in samples], np.int32)
            batch["qtype_label"] = np.array(
                [qtype_index(s["type"]) for s in samples], np.int32)
            batch["name"] = np.array(names)
            batch["qid"] = np.array(
                [int(s.get("question_id", -1)) for s in samples], np.int64)
            if ds.quest_feat is not None:
                quests = [ds._load_npy(ds.quest_feat,
                                       str(int(s["question_id"])))
                          for s in samples]
                batch["quest"] = np.stack(quests).astype(np.float32)
                if ds.prompt_feat is not None:
                    prompts = [ds._load_npy(ds.prompt_feat,
                                            str(int(s["question_id"])))
                               for s in samples]
                    batch["prompt"] = np.stack(prompts).astype(np.float32)
            else:
                batch["quest"] = ds.tokenizer(
                    [s["question_content"] for s in samples], truncate=True)
            batch["valid"] = np.concatenate(
                [np.ones(len(idxs), bool), np.zeros(n_pad, bool)])
            batch["ds_idx"] = np.asarray(
                list(idxs) + [fill] * n_pad, np.int32)
            return batch

        items = [ds[int(i)] for i in idxs]
        n_pad = self.batch_size - len(items)
        if n_pad:
            items.extend([items[0] if items else ds[fill]] * n_pad)
        batch = {}
        for key in items[0]:
            if key == "name":
                batch[key] = np.array([it[key] for it in items])
            else:
                batch[key] = np.stack([it[key] for it in items])
        batch["valid"] = np.concatenate(
            [np.ones(len(idxs), bool), np.zeros(n_pad, bool)])
        # global dataset row per sample (pads repeat row 0 of the batch, like
        # the sample padding above) — lets the runner's question cache gather
        # precomputed tower features by row instead of re-encoding tokens
        batch["ds_idx"] = np.asarray(
            list(idxs) + [fill] * n_pad, np.int32)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        order = self._indices()
        # len(self) chunks; those past the end of a short shard are empty
        # and become batches of padding
        chunks = [order[i * self.batch_size: (i + 1) * self.batch_size]
                  for i in range(len(self))]
        if self.prefetch <= 0:
            for chunk in chunks:
                yield self._make_batch(chunk)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            # a batch that fails to load (a missing or truncated feature
            # file, an unknown answer) reaches the consumer as its exception,
            # not as an early end of the epoch
            try:
                for chunk in chunks:
                    q.put(self._make_batch(chunk))
            except BaseException as exc:
                q.put(exc)
            else:
                q.put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            batch = q.get()
            if batch is stop:
                break
            if isinstance(batch, BaseException):
                thread.join()
                raise batch
            yield batch
        thread.join()
