"""hubert-xlarge [audio] — encoder-only transformer (w2v2 arch). 48L
d_model=1280 16H d_ff=5120 vocab=504 (masked-unit prediction targets).
Frame frontend is a STUB (precomputed frame embeddings). No decode shapes.
[arXiv:2106.07447]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    input_mode="embeddings",
    norm_type="layer",
    ffn_glu=False,
    ffn_act="gelu",
    source="arXiv:2106.07447",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=63, param_dtype="float32", compute_dtype="float32",
        xent_chunk=64, remat=False,
    )
