from qa_tiger_tpu_torch.utils.config import load_config_module
from qa_tiger_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger", "load_config_module"]
