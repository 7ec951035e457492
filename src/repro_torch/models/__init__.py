from repro_torch.models.model import init_params, param_count

__all__ = ["init_params", "param_count"]
