"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000. anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only (mistral-7b); the vision tower is a STUB per the assignment:
``input_specs()`` provides precomputed anyres patch embeddings [B, n_img, D]
which the model prepends to the token embeddings.
"""

from repro_torch.configs.base import ModelConfig

# 576 patches/tile x ~5 anyres tiles ≈ 2880 image-embedding positions.
NUM_IMAGE_EMBEDS = 2880

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, rope_theta=1000000.0, block_pattern=("dense",),
    frontend="vision",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-smoke", family="vlm", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16,
        block_pattern=("dense",), frontend="vision", dtype="float32", remat=False,
    )
