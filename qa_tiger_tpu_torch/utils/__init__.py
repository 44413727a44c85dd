from qa_tiger_tpu_torch.utils.config import load_config_module

__all__ = ["load_config_module"]
