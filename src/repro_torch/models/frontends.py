"""Modality-frontend stubs: the backbone takes precomputed patch or frame
embeddings, which these helpers make from a ``torch.Generator`` for smoke
runs (the reference draws them from a PRNG key; the numbers differ).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def vision_patch_embeds(cfg: ModelConfig, batch: int, num_patches: int,
                        generator: torch.Generator, *, device="cuda") -> torch.Tensor:
    """Anyres patch embeddings [batch, num_patches, d_model] in the model's
    dtype, as a CLIP tower and projector would hand them to the backbone."""
    x = torch.randn((batch, num_patches, cfg.d_model), generator=generator,
                    dtype=torch.float32, device=device)
    return (x * 0.02).to(getattr(torch, cfg.dtype))


def audio_frame_tokens(cfg: ModelConfig, batch: int, seq: int,
                       generator: torch.Generator, *, device="cuda") -> torch.Tensor:
    """EnCodec token ids [batch, seq] int32 in the codebook vocabulary, as
    an encoder would produce them."""
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                         dtype=torch.int32, device=device)


def num_frontend_embeds(cfg: ModelConfig) -> int:
    if cfg.frontend == "vision":
        from repro_torch.configs.llava_next import NUM_IMAGE_EMBEDS
        return NUM_IMAGE_EMBEDS
    return 0
