"""Evaluation entry point:
``python -m qa_tiger_tpu_torch.test --config C --weight W --output_path O``.

Port of ``src/test.py`` (the reference's src/test.py): the mode is forced
to "test"; the first test split's dataset is built before the model, so
that ``num_labels`` comes from its ``answer2idx.json``; the model is loaded
with the CLIP text weights and ``--weight``; the test split is evaluated,
then each of ``data.test_annots``. The report goes to
``<output_path>/<weight_stem>_result.txt``. The device rule is the train
entry point's (``hyper_params.platform``; no fallback from the card).

``--distributed`` under torchrun (the train entry point's launch): each
rank evaluates its strided shard of every split, the counters are summed
over the ranks, and rank 0 alone writes the report (src/test.py:89-91).
"""
from __future__ import annotations

from qa_tiger_tpu_torch import parallel
from qa_tiger_tpu_torch.data import AVQADataset
from qa_tiger_tpu_torch.train import ROOT, build_runner, eval_loader, setup
from qa_tiger_tpu_torch.utils import get_logger


def main(argv: list[str] | None = None) -> list[float]:
    """Evaluate as the config and ``argv`` say; returns each split's total
    accuracy."""
    cfg, _, _, device = setup(argv, mode="test")
    logger = get_logger()
    first_ds = AVQADataset(cfg, mode="test", repo_root=ROOT)
    runner = build_runner(cfg, device)

    accs = [runner.test(eval_loader(first_ds, cfg))]
    if isinstance(cfg.data.get("test_annots"), (list, tuple)):
        for annot in cfg.data.test_annots:
            cfg.data.test_annot = annot
            logger.info(f"\nTesting... {annot}")
            accs.append(runner.test(eval_loader(AVQADataset(cfg, mode="test", repo_root=ROOT),
                                                cfg)))
    return accs


if __name__ == "__main__":
    main()
    parallel.shutdown()
