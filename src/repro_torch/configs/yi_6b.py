"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA. [arXiv:2403.04652; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=4, d_ff=11008, vocab_size=64000,
    head_dim=128, rope_theta=5000000.0, block_pattern=("dense",),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        head_dim=16, block_pattern=("dense",), dtype="float32", remat=False,
    )
