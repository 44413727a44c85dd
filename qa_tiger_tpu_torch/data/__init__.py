"""The data layer: annotations, the CLIP tokenizer, the QA prompts, the
feature dataset and its batch loader, the native .npy reader.

Port of ``qa_tiger_tpu/data`` (its loader-library adapter
``grain_source.py`` excepted: ``AVQARunner`` takes any loader with
``__len__``, ``__iter__`` and ``set_epoch``)."""
from qa_tiger_tpu_torch.data.annotations import (
    load_annotations,
    load_answer_vocab,
    qtype2idx,
    qtype_index,
)
from qa_tiger_tpu_torch.data.dataset import AVQADataset, BatchLoader
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer, tokenize

__all__ = [
    "qtype2idx",
    "load_annotations",
    "load_answer_vocab",
    "qtype_index",
    "ClipTokenizer",
    "tokenize",
    "AVQADataset",
    "BatchLoader",
]
