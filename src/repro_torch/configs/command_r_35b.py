"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000. GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense", num_layers=40, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=22528, vocab_size=256000,
    head_dim=128, rope_theta=10000.0, block_pattern=("dense",),
    tie_embeddings=True,  # command-r ties input/output embeddings
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", family="dense", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=512,
        head_dim=8, block_pattern=("dense",), tie_embeddings=True,
        dtype="float32", remat=False,
    )
