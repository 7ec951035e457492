from repro_torch.models.model import apply, init_params, loss_fn, param_count

__all__ = ["apply", "init_params", "loss_fn", "param_count"]
