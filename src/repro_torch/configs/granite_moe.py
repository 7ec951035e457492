"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49155,
    head_dim=64, rope_theta=10000.0, block_pattern=("moe",),
    num_experts=40, num_experts_per_tok=8, expert_d_ff=512,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=512, head_dim=16,
        block_pattern=("moe",), num_experts=4, num_experts_per_tok=2,
        expert_d_ff=64, capacity_factor=4.0, dtype="float32", remat=False,
    )
