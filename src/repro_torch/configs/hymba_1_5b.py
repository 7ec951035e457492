"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Parallel attn+mamba heads. [arXiv:2411.13676; hf]

Attention heads use a sliding window (Hymba uses SWA in all but 3 layers; we
model all-SWA) so the decode state is O(window + ssm_state) => runs long_500k.
Hymba's learnable meta-tokens are not modeled (noted in DESIGN.md).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", num_layers=32, d_model=1600,
    num_heads=25, num_kv_heads=5, d_ff=5504, vocab_size=32001,
    head_dim=64, rope_theta=10000.0, block_pattern=("hymba",),
    ssm_state=16, ssm_heads=25, ssm_head_dim=64, sliding_window=1024,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", family="hybrid", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        block_pattern=("hymba",), ssm_state=4, ssm_heads=4, ssm_head_dim=16,
        sliding_window=16, dtype="float32", remat=False,
    )
