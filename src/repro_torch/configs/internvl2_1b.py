"""internvl2-1b [vlm] — InternViT frontend (STUB) + InternLM2-1B backbone.

Backbone per assignment: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. [arXiv:2404.16821; hf]. The vision frontend supplies
precomputed patch embeddings (input_mode='embeddings') per the task spec.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    input_mode="embeddings",
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=251, param_dtype="float32", compute_dtype="float32",
        xent_chunk=64, remat=False,
    )
