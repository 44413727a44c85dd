"""Config, seeding, run logging, and the profiling (``utils.profiling``) and
benchmark (``utils.benchmark``) helpers. Port of ``qa_tiger_tpu/utils``;
its persistent compilation cache (``cache.py``) has no counterpart: the
port compiles only its kernels, once per source hash, into ``build/``."""
from qa_tiger_tpu_torch.utils.config import Box, arg_parse, build_config, load_config_module
from qa_tiger_tpu_torch.utils.logging import (
    calculate_parameters,
    get_logger,
    logging_config,
    save_code_snapshot,
    set_logger,
)
from qa_tiger_tpu_torch.utils.seed import seed_everything

__all__ = [
    "Box",
    "arg_parse",
    "build_config",
    "load_config_module",
    "seed_everything",
    "get_logger",
    "set_logger",
    "save_code_snapshot",
    "logging_config",
    "calculate_parameters",
]
