"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
16 experts top-4 (fine-grained). [hf:databricks/dbrx-base]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    ffn_pattern=("moe",),
    num_experts=16,
    top_k=4,
    capacity_factor=1.25,
    rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
        vocab_size=251, num_experts=4, top_k=2, capacity_factor=4.0,
        param_dtype="float32", compute_dtype="float32", xent_chunk=64, remat=False,
    )
