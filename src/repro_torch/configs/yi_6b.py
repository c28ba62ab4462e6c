"""yi-6b [dense] — llama-arch GQA. 32L d_model=4096 32H (kv=4) d_ff=11008
vocab=64000. [arXiv:2403.04652; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=251, param_dtype="float32", compute_dtype="float32",
        xent_chunk=64, remat=False,
    )
