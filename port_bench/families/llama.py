"""The Llama-style stack of one kind of block, dense or MoE: the family of a
configuration file without a ``"family"`` key.

A family module is how the harness reaches what one model family needs,
so that a family joins the benchmark by files alone (README.md, "Adding a
model family"). This one hands on to the benchmark's modules for the
stack: ``weights.py``, ``reference/model.py`` and ``model_flops.py``.
"""

from __future__ import annotations

from port_bench import model_flops, weights
from port_bench.reference import model as ref

# the file's mixer and MLP names (``layer_types``, ``mlp_layer_types``) that
# are this stack's attention, dense MLP and experts
ATTENTION = ("attention", "full_attention")
MLP_KIND = {"dense": "dense", "moe": "moe", "sparse": "moe"}

logits = ref.logits
control_precision = ref.control_precision
step_flops = model_flops.step_flops


def stack_kind(cfg: dict) -> str:
    return "moe" if weights.moe(cfg) else "dense"


def expected_blocks(cfg: dict) -> tuple:
    """The port's block kind of each layer that the file's ``layer_types``
    and ``mlp_layer_types`` expand to (an attention layer takes its MLP's
    kind; any other mixer keeps its own name, which this stack has not);
    without either key, the stack's one kind."""
    if "layer_types" not in cfg and "mlp_layer_types" not in cfg:
        return (stack_kind(cfg),)
    L = cfg["num_hidden_layers"]
    mixers = cfg.get("layer_types", ["attention"] * L)
    mlps = cfg.get("mlp_layer_types", [stack_kind(cfg)] * L)
    return tuple(MLP_KIND.get(m, m) if x in ATTENTION else x for x, m in zip(mixers, mlps))


def make_weights(cfg: dict, seed: int, device) -> dict:
    if set(expected_blocks(cfg)) != {stack_kind(cfg)}:
        raise ValueError(f"{cfg['arch']}: the llama family builds a stack of "
                         f"{stack_kind(cfg)} blocks alone; a mixed stack names a "
                         "family of its own (port_bench/README.md)")
    return weights.make_weights(cfg, seed, device)


def capacity(tokens: int, cfg: dict) -> int:
    """The slots an expert has in a forward call of ``tokens``; 0 without
    experts."""
    return ref.capacity(tokens, cfg) if weights.moe(cfg) else 0


def config_fields(cfg: dict, pc) -> dict:
    """{key: (the file's value, the program's)} that the harness's own
    comparison (``harness.PORT_FIELDS``) does not make alike for every
    family: the file's ``intermediate_size`` is an expert's width in an
    MoE, and a dense model has no capacity factor."""
    moe = weights.moe(cfg)
    out = {"intermediate_size": (cfg["intermediate_size"],
                                 pc.expert_d_ff if moe else pc.d_ff)}
    if not moe:
        out["capacity_factor"] = (pc.capacity_factor, pc.capacity_factor)
    return out


def config_dict(arch: str, pc) -> dict:
    """The configuration-file form of the port's config ``pc`` (the smoke
    cells')."""
    cfg = {"arch": arch, "kv_head_map": "h % KV",
           "num_hidden_layers": pc.num_layers, "hidden_size": pc.d_model,
           "intermediate_size": pc.expert_d_ff if pc.num_experts else pc.d_ff,
           "num_attention_heads": pc.num_heads, "num_key_value_heads": pc.num_kv_heads,
           "head_dim": pc.resolved_head_dim, "vocab_size": pc.vocab_size,
           "rope_theta": pc.rope_theta, "hidden_act": pc.act, "rms_norm_eps": 1e-6,
           "tie_word_embeddings": pc.tie_embeddings, "torch_dtype": pc.dtype}
    if pc.num_experts:
        cfg.update(num_local_experts=pc.num_experts,
                   num_experts_per_tok=pc.num_experts_per_tok,
                   capacity_factor=pc.capacity_factor, min_capacity=8)
    return cfg
