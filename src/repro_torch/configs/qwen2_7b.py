"""qwen2-7b [dense] — GQA with QKV bias. 28L d_model=3584 28H (kv=4)
d_ff=18944 vocab=152064. [arXiv:2407.10671; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=251, param_dtype="float32", compute_dtype="float32",
        xent_chunk=64, remat=False,
    )
