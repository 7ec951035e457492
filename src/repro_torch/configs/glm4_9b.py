"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
RoPE, GQA. [hf:THUDM/glm-4-9b; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
    head_dim=128, rope_theta=10000.0, block_pattern=("dense",),
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        head_dim=16, block_pattern=("dense",), dtype="float32", remat=False,
    )
