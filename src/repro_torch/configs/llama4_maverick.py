"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128e top-1. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE layers interleave with dense layers (pattern dense,moe), matching the
published "every other layer routed" structure that lands total params near
400B with ~17B active (top-1 of 128 experts, expert_d_ff=8192).
The shared-expert path and early-fusion multimodality are not modeled (the
assignment specifies the LM backbone; early fusion enters via input embeddings).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", num_layers=48,
    d_model=5120, num_heads=40, num_kv_heads=8, d_ff=8192, vocab_size=202048,
    head_dim=128, rope_theta=500000.0, block_pattern=("dense", "moe"),
    num_experts=128, num_experts_per_tok=1, expert_d_ff=8192,
    optimizer_state_dtype="bfloat16",  # 400B params: bf16 moments (DESIGN.md)
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        block_pattern=("dense", "moe"), num_experts=4, num_experts_per_tok=1,
        expert_d_ff=128, capacity_factor=4.0, dtype="float32", remat=False,
    )
