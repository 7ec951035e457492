"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

Constant-size recurrent state => runs long_500k (DESIGN.md §4). The paged-KV
CMP path is inapplicable (no KV cache); recurrent state uses a degenerate
2-slot pool (double buffering, window W=1) — noted inapplicability.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    head_dim=192, block_pattern=("mlstm", "slstm"),
    ssm_heads=4, ssm_head_dim=192,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=512, head_dim=16,
        block_pattern=("mlstm", "slstm"), ssm_heads=4, ssm_head_dim=16,
        dtype="float32", remat=False,
    )
