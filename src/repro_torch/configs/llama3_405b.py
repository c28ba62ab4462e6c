"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    source="arXiv:2407.21783",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=251, param_dtype="float32", compute_dtype="float32",
        xent_chunk=64, remat=False,
    )
