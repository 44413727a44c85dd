"""Observability: the run logger, a TensorBoard writer, the code snapshot,
the config and environment dump, the parameter report.

This package's own copy of ``qa_tiger_tpu/utils/logging.py`` (the
reference's src/utils.py:96-232):

- the "AVQA" logger at INFO on the main process and WARNING on the others,
  the rank read from ``torch.distributed`` when a process group is up;
- a train run's directory ``<output_dir>/<timestamp>_seed<seed>/`` with
  ``log.txt``, a TensorBoard writer and a zip of this package's source;
- a test run's ``<output_path>/<weight_stem>_result.txt``;
- the config and the environment (torch, CUDA, the devices) in the log;
- total and tunable parameter counts.

TensorBoard is optional: without ``tensorboard`` or ``tensorboardX`` the
writer is a stub that drops every scalar.
"""
from __future__ import annotations

import json
import logging
import os
import platform
import zipfile
from collections.abc import Mapping
from datetime import datetime
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist

LOGGER_NAME = "AVQA"


def _is_main_process() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def get_logger() -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO if _is_main_process() else logging.WARNING)
    return logger


class SummaryWriterStub:
    """No-op TensorBoard writer, for when tensorboard isn't importable."""

    def add_scalar(self, *args: Any, **kwargs: Any) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _make_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except Exception:
        try:
            from tensorboardX import SummaryWriter

            return SummaryWriter(logdir)
        except Exception:
            return SummaryWriterStub()


def save_code_snapshot(folder: str, logging_path: Path,
                       file_name: str = "code_snapshot.zip") -> None:
    """Zip every .py file under ``folder`` into the run directory, for
    provenance (ref src/utils.py:110-133)."""
    if folder is None:
        raise ValueError("Please specify the directory to snapshot")
    if not _is_main_process():
        return
    save_name = str(Path(logging_path) / file_name)
    with zipfile.ZipFile(save_name, "w") as zipf:
        for dirpath, _dirnames, filenames in os.walk(folder):
            for filename in filenames:
                if filename.endswith(".py"):
                    file_path = os.path.join(dirpath, filename)
                    zipf.write(file_path, os.path.relpath(file_path, folder))
    print(f"Code snapshot saved as {save_name}")


def _attach_handlers(logger: logging.Logger, file_path: str | None) -> None:
    formatter = logging.Formatter("[%(asctime)s]-[%(filename)s line:%(lineno)d]:%(message)s ")
    console_handler = logging.StreamHandler()
    console_handler.setFormatter(formatter)
    logger.addHandler(console_handler)
    if file_path is not None:
        file_handler = logging.FileHandler(file_path, mode="w")
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)


def set_logger(cfg) -> tuple[Any, str]:
    """Create the run directory or the result file and wire up logging.

    Train mode: ``<output_dir>/<timestamp>_seed<seed>/`` with a TensorBoard
    writer, log.txt and a code snapshot zip (ref src/utils.py:159-190); with
    ``debug`` nothing is written. Under a process group rank 0 alone writes
    them (the writer is None elsewhere) and its timestamp is every rank's.
    Test mode: the log goes to ``<output_path>/<weight_stem>_result.txt``,
    or beside the weight file when no output path is given (ref
    src/utils.py:138-158); rank 0 alone writes it. Returns
    ``(writer or None, timestamp)``. Unlike the reference, it leaves the
    process's warning filters as they are.
    """
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()

    if cfg.mode == "test":
        if cfg.get("output_path"):
            out_dir = Path(cfg.output_path)
            out_dir.mkdir(parents=True, exist_ok=True)
            result_path = out_dir / (Path(str(cfg.weight)).stem + "_result.txt")
        else:
            weight = str(cfg.weight)
            for suffix in (".pt", ".npz"):
                if weight.endswith(suffix):
                    weight = weight[: -len(suffix)]
                    break
            result_path = Path(weight + "_result.txt")
        if _is_main_process():
            _attach_handlers(logger, str(result_path))
        return None, ""

    timestamp = "{0:%Y-%m-%d-%H-%M-%S}".format(datetime.now()) + f"_seed{cfg.seed}"
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        # rank 0's: every rank reads back what rank 0 writes to the run dir
        shared = [timestamp]
        dist.broadcast_object_list(shared, src=0)
        timestamp = shared[0]
    writer = None
    if not cfg.debug and _is_main_process():
        out_dir = Path(cfg.output_dir) / timestamp
        out_dir.mkdir(parents=True, exist_ok=True)
        writer = _make_writer(out_dir.as_posix())
        _attach_handlers(logger, str(out_dir / "log.txt"))
        pkg_root = Path(__file__).resolve().parents[1]
        save_code_snapshot(pkg_root.as_posix(), out_dir)
    elif _is_main_process():
        _attach_handlers(logger, None)
    return writer, timestamp


def calculate_parameters(model_or_params, frozen_prefixes: tuple = ()) -> dict:
    """Report total / tunable parameter counts (ref src/utils.py:193-210).

    ``model_or_params`` is a module or a state_dict (dotted names ->
    tensors); names under any of ``frozen_prefixes`` count as not tunable
    (requires_grad=False on the frozen encoder). Names are listed in the JAX
    package's order, its pytree's keys sorted at every level. Returns the
    counts and the tunable names."""
    logger = get_logger()
    params: Mapping = (model_or_params.state_dict()
                       if isinstance(model_or_params, torch.nn.Module) else model_or_params)
    tot_params = 0
    tune_params = 0
    tune_list = []
    for name in sorted(params, key=lambda n: n.split(".")):
        n = int(torch.as_tensor(params[name]).numel())
        tot_params += n
        if not any(name.startswith(pref) for pref in frozen_prefixes):
            tune_params += n
            tune_list.append(name)
    ratio = (tune_params / max(tot_params, 1)) * 100
    logger.info("\n-------------- parameter info --------------")
    logger.info(f"num total params: {tot_params}")
    logger.info(f"num tunable params: {tune_params}")
    logger.info(f"tunable param ratio: {ratio:.2f}%")
    logger.info("tunable params:")
    logger.info(json.dumps(tune_list, indent=4))
    return {"total": tot_params, "tunable": tune_params, "tunable_names": tune_list}


def logging_config(cfg) -> None:
    """Dump the config and the environment (ref src/utils.py:213-232):
    torch, its CUDA and the devices."""
    logger = get_logger()
    logger.info("\n-------------- config --------------")
    to_dump = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
    logger.info(json.dumps(to_dump, indent=4, default=str))
    logger.info("\n-------------- environment --------------")
    logger.info(f"Kernel version: {platform.platform()}")
    logger.info(f"Python version: {platform.python_version()}")
    logger.info(f"torch version: {torch.__version__}")
    logger.info(f"CUDA version: {torch.version.cuda}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    logger.info(f"device count: {count}")
    for i in range(count):
        logger.info(f"ㄴdevice {i}: {torch.cuda.get_device_name(i)} (cuda)")
