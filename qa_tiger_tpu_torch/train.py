"""Training entry point: ``python -m qa_tiger_tpu_torch.train --config C``.

Port of ``src/train.py`` (the reference's src/train.py:26-114), step for
step: config and run directory -> loaders -> model and ``AVQARunner`` ->
CLIP text weights -> ``--weight`` -> parameter report -> question caches ->
LR schedule -> ``resume`` -> the epoch loop (train, evaluate, LR step,
``best.npz`` at each best epoch, the train state in ``last_state/``) -> the
final test on ``best.npz``, then on each of ``data.test_annots``.

The device comes from ``hyper_params.platform``: ``"cpu"`` runs on the
CPU; absent, ``"gpu"`` or ``"cuda"`` runs on the card and raises when there
is none; there is no fallback. The JAX entry point's compilation cache has
no counterpart here (ROADMAP.md A9).

``--distributed``: data-parallel training, one process per card, launched
by torchrun::

    python -m torch.distributed.run --nproc-per-node N \
        -m qa_tiger_tpu_torch.train --config C --distributed

Each rank joins the process group (NCCL, or gloo with ``platform='cpu'``),
takes ``cuda:LOCAL_RANK``, reads a strided shard of every batch at
``batch_size // world`` rows (``eval_batch_size // world`` for the eval
loaders; the world size must divide both) and starts from rank 0's weights;
the runner reduces the gradients, losses and counters. Only rank 0 writes
the run directory, ``best.npz``, ``last_state/`` and the carried-over best
checkpoint, and every rank waits for them before it reads them back.
"""
from __future__ import annotations

import shutil
from pathlib import Path

import torch

from qa_tiger_tpu_torch import parallel
from qa_tiger_tpu_torch.data import AVQADataset, BatchLoader
from qa_tiger_tpu_torch.models.registry import model_config, select_device
from qa_tiger_tpu_torch.training import (
    AVQARunner,
    PlateauScheduler,
    load_checkpoint,
    load_train_state,
    make_lr_schedule,
    save_checkpoint,
    save_train_state,
    save_train_state_async,
    wait_for_async_saves,
)
from qa_tiger_tpu_torch.utils import (
    arg_parse,
    build_config,
    calculate_parameters,
    get_logger,
    logging_config,
    seed_everything,
    set_logger,
)

ROOT = Path(__file__).resolve().parents[1]


def setup(argv, mode: str | None = None):
    """Parse ``argv``, build the config (``mode`` forced when given), join
    the process group with ``--distributed``, open the run's log and seed:
    returns (cfg, writer, timestamp, device)."""
    args = arg_parse(argv)
    if mode is not None:
        args.mode = mode
    cfg = build_config(args)
    if args.distributed:
        parallel.init_distributed(cfg.hyper_params.get("platform"))
        check_batch_sizes(cfg, parallel.world())
    device = select_device(cfg)  # before the run directory: no card, no run
    writer, timestamp = set_logger(cfg)
    logging_config(cfg)
    seed_everything(cfg.seed)
    return cfg, writer, timestamp, device


def check_batch_sizes(cfg, world: int) -> None:
    """Each rank takes ``batch_size // world`` and ``eval_batch_size //
    world`` rows: the world size must divide both. (The JAX entry point
    shrinks its mesh to a divisor instead, which a process group cannot.)"""
    sizes = {k: int(cfg.data[k]) for k in ("batch_size", "eval_batch_size")}
    if any(v % world for v in sizes.values()):
        raise ValueError(f"--distributed over {world} ranks: data.batch_size={sizes['batch_size']} "
                         f"and data.eval_batch_size={sizes['eval_batch_size']} must both be "
                         f"multiples of {world}")


def build_runner(cfg, device: torch.device) -> AVQARunner:
    """The runner of the config's model on ``device``, with the CLIP text
    weights of ``hyper_params.model.clip_weights`` and the ``weight``
    checkpoint loaded when the config names them; under a process group,
    rank 0's weights on every rank."""
    logger = get_logger()
    mcfg = model_config(cfg.hyper_params.model_type, cfg.hyper_params.model,
                        num_labels=cfg.get("num_labels", 42))
    runner = AVQARunner(cfg, mcfg, device=device, seed=cfg.seed)
    clip_weights = cfg.hyper_params.model.get("clip_weights")
    if clip_weights:
        runner.load_clip_text_weights(clip_weights)
    if cfg.get("weight"):
        params, missing, unexpected = load_checkpoint(cfg.weight, runner.params)
        logger.info(f"Missing keys: {missing}")
        logger.info(f"Unexpected keys: {unexpected}")
        logger.info(f"=> loaded successfully '{cfg.weight}'")
        runner.load_params(params)
    parallel.broadcast_params(runner.model)
    return runner


def eval_loader(dataset: AVQADataset, cfg) -> BatchLoader:
    """This rank's shard of ``dataset`` in order, ``eval_batch_size //
    world`` rows per batch (src/train.py:197-213)."""
    world = parallel.world()
    return BatchLoader(dataset, cfg.data.eval_batch_size // world, shuffle=False,
                       shard_id=parallel.rank(), num_shards=world)


def make_loaders(cfg) -> dict[str, BatchLoader]:
    """The train loader (shuffled in train mode) and the validation loader,
    each this rank's shard at the per-rank batch size (src/train.py:44-56)."""
    world = parallel.world()
    train_ds = AVQADataset(cfg, mode=cfg.mode, repo_root=ROOT)
    val_ds = AVQADataset(cfg, mode="valid", repo_root=ROOT)
    train_loader = BatchLoader(train_ds, cfg.data.batch_size // world,
                               shuffle=(cfg.mode == "train"), seed=cfg.seed,
                               shard_id=parallel.rank(), num_shards=world)
    return {cfg.mode: train_loader, "val": eval_loader(val_ds, cfg)}


def main(argv: list[str] | None = None) -> dict:
    """Train as the config says; returns a summary: the run directory, the
    first epoch, each epoch's ``epoch_stats`` and validation accuracy, the
    best accuracy and epoch, the final tests' accuracies, and the number of
    question caches built."""
    cfg, writer, timestamp, device = setup(argv)
    logger = get_logger()
    save_dir = Path(cfg.output_dir) / timestamp

    loaders = make_loaders(cfg)
    runner = build_runner(cfg, device)
    calculate_parameters(runner.params, frozen_prefixes=runner.model.FROZEN_PREFIXES)
    cache = cfg.hyper_params.get("cache_qst_features")
    if cache:
        # every split's questions through the (now loaded) frozen tower once;
        # steps gather rows by ds_idx instead of running the tower per batch
        for loader in loaders.values():
            runner.build_question_cache(loader.dataset)

    optim_cfg = cfg.hyper_params.optim
    sched_cfg = cfg.hyper_params.sched
    plateau = None
    if sched_cfg.name == "ReduceLROnPlateau":
        plateau = PlateauScheduler(optim_cfg.lr, mode=sched_cfg.mode, factor=sched_cfg.factor,
                                   patience=sched_cfg.patience)
        lr_for_epoch = None
    else:
        lr_for_epoch = make_lr_schedule(
            sched_cfg.name, optim_cfg.lr, epochs=cfg.epochs,
            step_size=sched_cfg.get("step_size", 8), gamma=sched_cfg.get("gamma", 0.1),
            min_lr=optim_cfg.get("min_lr", 1e-7),
            warmup_epochs=sched_cfg.get("warmup_epochs", 2))

    best_acc, best_epoch = 0.0, -1
    start_epoch = 1
    carried_over = None
    resume_dir = cfg.get("resume")
    if resume_dir:
        # params, Adam's state, the dropout stream and the epoch: a bitwise
        # mid-training resume
        scalars = runner.restore_train_state(load_train_state(resume_dir))
        start_epoch = int(scalars.get("epoch", 0)) + 1
        best_acc = float(scalars.get("best_acc", 0.0))
        best_epoch = int(scalars.get("best_epoch", -1))
        logger.info(f"resumed from {resume_dir} at epoch {start_epoch}")
        # the best checkpoint lives beside the resumed last_state in the
        # original run directory; the final test below needs it here when no
        # later epoch beats best_acc
        prev_best = Path(resume_dir).parent / "best.npz"
        carry = prev_best.exists() and not (save_dir / "best.npz").exists()
        # every rank decides before rank 0 copies, and reads after it has
        parallel.sync_processes("the check for a best.npz to carry over")
        if carry:
            if parallel.is_main():
                shutil.copy2(prev_best, save_dir / "best.npz")
            carried_over = str(prev_best)
            logger.info(f"carried over best checkpoint from {prev_best}")
        parallel.sync_processes("the carried-over best.npz")

    summary = {"run_dir": str(save_dir), "start_epoch": start_epoch, "epochs": [],
               "carried_over": carried_over, "tests": []}
    current_lr = optim_cfg.lr
    for epoch in range(start_epoch, cfg.epochs + 1):
        if lr_for_epoch is not None:
            current_lr = lr_for_epoch(epoch)
        if writer is not None:
            writer.add_scalar("train/lr", current_lr, epoch)

        logger.info(f"\n-------------- training epoch {epoch} --------------")
        runner.train_epoch(epoch, loaders["train"], current_lr, writer)

        logger.info(f"\n-------------- validation epoch {epoch} --------------")
        acc, loss = runner.evaluate(epoch, loaders["val"], writer)
        summary["epochs"].append({**runner.epoch_stats, "val_acc": acc, "val_loss": loss})

        if plateau is not None:
            current_lr = plateau.step(acc if sched_cfg.mode == "max" else loss)

        if acc >= best_acc and not cfg.debug:
            best_acc, best_epoch = acc, epoch
            logger.info(f"best model saved at epoch {epoch} with acc {best_acc}")
            if parallel.is_main():
                save_checkpoint(runner.params, save_dir / "best.npz",
                                exclude_prefixes=("video_encoder",))
        if not cfg.debug and cfg.get("save_state", True) and parallel.is_main():
            state = runner.train_state(epoch=epoch, best_acc=best_acc, best_epoch=best_epoch)
            if cfg.get("save_state_async"):
                # written on a background thread while the next epoch runs
                save_train_state_async(state, save_dir / "last_state")
            else:
                save_train_state(state, save_dir / "last_state")
        logger.info(f"Epoch {epoch} done with {acc:3.2f} and loss {loss:.5f}.")
        logger.info(f"At epoch{best_epoch} best acc: {best_acc:3.2f}.")

    if cfg.get("save_state_async"):
        wait_for_async_saves()
    parallel.sync_processes("rank 0's best.npz and last_state")
    summary.update(best_acc=best_acc, best_epoch=best_epoch)

    if not cfg.debug:
        logger.info(f"\nTesting with Best validation model... {cfg.data.test_annot}")
        cfg.mode = "test"
        test_ds = AVQADataset(cfg, mode="test", repo_root=ROOT)
        params, _, _ = load_checkpoint(save_dir / "best.npz", runner.params)
        runner.load_params(params)
        if cache:
            runner.build_question_cache(test_ds)
        summary["tests"].append(runner.test(eval_loader(test_ds, cfg)))
        if isinstance(cfg.data.get("test_annots"), (list, tuple)):
            for test_annot in cfg.data.test_annots:
                logger.info(f"\nTesting with Best validation model... {test_annot}")
                cfg.data.test_annot = test_annot
                ds = AVQADataset(cfg, mode="test", repo_root=ROOT)
                if cache:
                    runner.build_question_cache(ds)
                summary["tests"].append(runner.test(eval_loader(ds, cfg)))
    summary["question_caches"] = len(runner._qst_caches)
    return summary


if __name__ == "__main__":
    main()
    parallel.shutdown()
