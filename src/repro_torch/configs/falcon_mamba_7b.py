"""falcon-mamba-7b [ssm] — attention-free Mamba-1. 64L d_model=4096 d_ff=0
vocab=65024, ssm_state=16. [arXiv:2410.05355]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65_024,
    pattern=("mamba",),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    source="arXiv:2410.05355",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, vocab_size=251, param_dtype="float32",
        compute_dtype="float32", xent_chunk=64, ssm_chunk=16, remat=False,
    )
