"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192
vocab=2048. Decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: ``input_specs()`` provides
token ids in the EnCodec codebook vocabulary (2048); the codebook delay
pattern is flattened to a single stream (noted in DESIGN.md).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=2048,
    head_dim=64, rope_theta=10000.0, block_pattern=("dense",),
    norm="layernorm", act="gelu", frontend="audio",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128, head_dim=16,
        block_pattern=("dense",), norm="layernorm", act="gelu",
        frontend="audio", dtype="float32", remat=False,
    )
