"""Config system: ModelConfig dataclass, input-shape registry, arch registry.

Every assigned architecture is a module in this package exposing ``CONFIG``
(the exact published shape) and ``smoke_config()`` (a reduced same-family
variant for CPU tests). Select with ``--arch <id>`` in the launchers.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # block structure: pattern repeated num_layers/len(pattern) times
    block_pattern: Tuple[str, ...] = ("dense",)
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    # attention details
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    attn_softcap: float = 0.0
    # misc
    norm: str = "rmsnorm"
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    frontend: Optional[str] = None   # vision | audio (stub embeddings)
    remat: bool = True
    attention_impl: str = "ref"      # ref | pallas
    ssd_chunk: int = 256
    # memory-efficient (online-softmax) cache attention: process the KV cache
    # in blocks of this size when S>1 and T>block (prefill); 0 disables.
    attn_chunk_kv: int = 1024
    # scan unroll knobs (dry-run cost extrapolation; see launch/dryrun.py)
    scan_unroll: int = 1         # layer scan
    time_scan_unroll: int = 1    # ssm/recurrent time scans
    attn_scan_unroll: int = 1    # chunked-attention KV scan
    # mesh axes carrying the batch dim (set by the launcher when lowering on
    # a mesh). The embedding gather's output sharding is ambiguous (token ids
    # want batch->data, embed columns want D->data); without an explicit
    # constraint GSPMD replicates the batch and attention computes 16x
    # redundant work (measured — see EXPERIMENTS.md §Perf iteration 1).
    batch_axes: Optional[Tuple[str, ...]] = None
    # --- beyond-paper optimization knobs (§Perf hillclimb) ---
    # dispatch MoE within token groups (gathers/sorts become group-local;
    # set to the number of data shards): 1 = global dispatch
    moe_groups: int = 1
    # constrain chunked-attention KV blocks to this mesh axis (prevents the
    # GSPMD involuntary full rematerialization when scanning a cache whose
    # time dim is sharded)
    kv_block_axis: Optional[str] = None
    # parameter sharding mode: "2d" (FSDP x TP), "tp" (replicate over data —
    # stationary weights for decode), "dp" (replicate over model — pure DP
    # for small models)
    param_mode: str = "2d"
    # shard recurrent state over this mesh axis (mLSTM value dim — makes the
    # time scan collective-free under TP; §Perf cell B)
    ssm_shard_axis: Optional[str] = None
    # optimizer memory policy (bf16 moments for very large models)
    optimizer_state_dtype: str = "float32"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def pattern_repeats(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers {self.num_layers} not divisible by "
            f"pattern {self.block_pattern}")
        return self.num_layers // len(self.block_pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state does not grow with full context (may run
        long_500k)."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "glm4_9b", "yi_6b", "phi3_mini", "command_r_35b", "llama4_maverick",
    "granite_moe", "xlstm_125m", "hymba_1_5b", "llava_next", "musicgen_large",
]

# canonical ids as given in the assignment -> module names
_ALIASES = {
    "glm4-9b": "glm4_9b",
    "yi-6b": "yi_6b",
    "phi3-mini-3.8b": "phi3_mini",
    "command-r-35b": "command_r_35b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "granite-moe-3b-a800m": "granite_moe",
    "xlstm-125m": "xlstm_125m",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-mistral-7b": "llava_next",
    "musicgen-large": "musicgen_large",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell (DESIGN.md §4 skips)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md §4)"
    return True, ""
