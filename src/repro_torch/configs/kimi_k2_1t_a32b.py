"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 61L d_model=7168
64H (GQA kv=8, head_dim 112) d_ff=2048/expert, vocab=163840, 384 experts
top-8. [arXiv:2501.kimi2 per assignment]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,
    vocab_size=163_840,
    ffn_pattern=("moe",),
    num_experts=384,
    top_k=8,
    capacity_factor=1.25,
    source="arXiv:2501.kimi2 (assignment table)",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=251, num_experts=8, top_k=2, capacity_factor=4.0,
        param_dtype="float32", compute_dtype="float32", xent_chunk=64, remat=False,
    )
