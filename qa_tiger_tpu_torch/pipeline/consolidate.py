"""Feature-shard consolidation: thousands of per-video .npy files -> one
memory-mapped array + index.

This package's own copy of ``qa_tiger_tpu/pipeline/consolidate.py``. The
reference reads three .npy files per sample per step (src/dataset.py:134-159);
consolidation packs a feature directory into

    <dst>/features.npy   one [num_videos, *item_shape] float32 array
    <dst>/index.json     {video_id: row}

which the data layer serves by numpy memmap fancy-indexing: a batch is one
gather from the page cache, with no per-file opens.

The training config points the ``*_feat`` keys at the consolidated
directory; ``AVQADataset`` detects the layout.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def consolidate(feat_dir: str | Path, dst_dir: str | Path,
                dtype=np.float32) -> tuple[Path, int]:
    """Pack every ``<video_id>.npy`` under feat_dir into one shard."""
    feat_dir, dst_dir = Path(feat_dir), Path(dst_dir)
    files = sorted(feat_dir.glob("*.npy"))
    if not files:
        raise FileNotFoundError(f"no .npy files under {feat_dir}")
    first = np.load(files[0])
    item_shape = first.shape
    dst_dir.mkdir(parents=True, exist_ok=True)

    out_path = dst_dir / "features.npy"
    out = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=dtype, shape=(len(files), *item_shape))
    index = {}
    for row, f in enumerate(files):
        arr = np.load(f)
        if arr.shape != item_shape:
            raise ValueError(f"{f.name}: shape {arr.shape} != {item_shape}")
        out[row] = arr.astype(dtype)
        index[f.stem] = row
    out.flush()
    (dst_dir / "index.json").write_text(json.dumps(index))
    return out_path, len(files)


class ShardReader:
    """Memmap-backed batch reader for a consolidated shard."""

    def __init__(self, shard_dir: str | Path):
        shard_dir = Path(shard_dir)
        self.features = np.load(shard_dir / "features.npy", mmap_mode="r")
        self.index = json.loads((shard_dir / "index.json").read_text())

    @property
    def item_shape(self) -> tuple:
        return self.features.shape[1:]

    def __contains__(self, video_id: str) -> bool:
        return video_id in self.index

    def get(self, video_id: str) -> np.ndarray:
        return np.asarray(self.features[self.index[video_id]])

    def get_batch(self, video_ids) -> np.ndarray:
        rows = np.asarray([self.index[v] for v in video_ids])
        return np.asarray(self.features[rows])


def open_if_shard(path: Path | None) -> ShardReader | None:
    """ShardReader when ``path`` holds a consolidated shard, else None."""
    if path is not None and (Path(path) / "features.npy").exists():
        return ShardReader(path)
    return None
