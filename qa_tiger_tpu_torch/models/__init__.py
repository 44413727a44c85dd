from qa_tiger_tpu_torch.models.qa_tiger import QATiger, qa_tiger_config
from qa_tiger_tpu_torch.models.registry import build_model, model_class, model_config
from qa_tiger_tpu_torch.models.tspm import TSPM, tspm_config

__all__ = ["QATiger", "TSPM", "build_model", "model_class", "model_config", "qa_tiger_config",
           "tspm_config"]
