"""gemma2-27b [dense] — local+global alternating attention with logit
softcaps. 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
head_dim=128 (model spec; 32*128 != d_model by design — q/kv project to
4096). Sliding window 4096 on local layers. [arXiv:2408.00118; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    pattern=("attn_local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    ffn_act="gelu",
    source="arXiv:2408.00118; hf",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=251, window=8, param_dtype="float32",
        compute_dtype="float32", xent_chunk=64, remat=False,
    )
