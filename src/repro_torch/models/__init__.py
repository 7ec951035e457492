from repro_torch.models.model import (apply, decode_step, init_cache, init_params,
                                      loss_fn, param_count, prefill)

__all__ = ["apply", "decode_step", "init_cache", "init_params", "loss_fn",
           "param_count", "prefill"]
