"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192
vocab=32064. RoPE SwiGLU. [arXiv:2404.14219; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
    head_dim=96, rope_theta=10000.0, block_pattern=("dense",),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
        head_dim=16, block_pattern=("dense",), dtype="float32", remat=False,
    )
