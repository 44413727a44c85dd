from qa_tiger_tpu_torch.models.qa_tiger import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models.registry import build_model, model_config

__all__ = ["QATiger", "build_model", "model_config", "qa_tiger_config"]
