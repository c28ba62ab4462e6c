"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE every
other layer. 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
16 experts top-2. Period-8 pattern with attention at offset 4 (hf config).
[arXiv:2403.19887; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    ffn_pattern=(
        "dense", "moe", "dense", "moe", "dense", "moe", "dense", "moe",
    ),
    num_experts=16,
    top_k=2,
    capacity_factor=1.25,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2403.19887; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
        vocab_size=251, num_experts=4, top_k=2, capacity_factor=4.0,
        param_dtype="float32", compute_dtype="float32", xent_chunk=64,
        ssm_chunk=16, remat=False,
    )
