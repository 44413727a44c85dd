from qa_tiger_tpu_torch.models.qa_tiger import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models.registry import build_model

__all__ = ["QATiger", "build_model", "qa_tiger_config"]
