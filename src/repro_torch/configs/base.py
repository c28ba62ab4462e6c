"""Architecture configuration: a copy of the reference ``ModelConfig``.

Field for field the reference package's ``repro.configs.base.ModelConfig``,
so a config built from the same arguments describes the same model in both
packages.  The port reads the fields of the attention mixers and dense
FFNs; the MoE and SSM fields ride along so configs stay interchangeable.
"""

from __future__ import annotations

import dataclasses
import math

# The ONE attn_impl="auto" flip point: sequences at or below this run the
# dense lane, longer ones the streaming flash lane (models/attention.py::
# resolve_impl); attn_impl="pallas" takes the kernels at every length.
FLASH_THRESHOLD = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # layer pattern (repeating period; num_layers % len(pattern) == 0)
    pattern: tuple[str, ...] = ("attn",)  # 'attn' | 'attn_local' | 'mamba'
    ffn_pattern: tuple[str, ...] = ("dense",)  # 'dense' | 'moe'

    # attention details
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None  # sliding window for 'attn_local'
    rope_theta: float = 10_000.0
    causal: bool = True  # False => encoder-only (no decode shapes)

    # moe
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"  # 'gspmd' | 'ep' (shard_map explicit all-to-all)

    # ssm
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0  # 0 = ceil(d_model / 16)
    ssm_chunk: int = 256

    # io
    input_mode: str = "tokens"  # 'tokens' | 'embeddings' (audio/vlm stub frontend)
    norm_type: str = "rms"  # 'rms' | 'layer'
    ffn_act: str = "silu"  # activation inside (GLU-style) FFN
    ffn_glu: bool = True  # gated FFN (SwiGLU); False => plain 2-layer MLP

    # numerics / structure
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True
    xent_chunk: int = 512
    attn_impl: str = "auto"  # 'auto' | 'dense' | 'flash' | 'pallas'
    flash_threshold: int = FLASH_THRESHOLD  # auto: dense iff s <= threshold
    flash_q_block: int = 512
    flash_kv_block: int = 1024
    moe_groups: int = 0  # 0 => data shard count at call time

    # metadata
    source: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(f"{self.name}: num_layers % pattern period != 0")
        if len(self.ffn_pattern) not in (1, len(self.pattern)):
            # allow ffn_pattern either scalar-like or same period
            if len(self.pattern) % len(self.ffn_pattern) != 0:
                raise ValueError(f"{self.name}: ffn_pattern period mismatch")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads if self.num_heads else 0)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def repeats(self) -> int:
        return self.num_layers // self.period

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, math.ceil(self.d_model / 16))

    def ffn_kind(self, pos: int) -> str:
        return self.ffn_pattern[pos % len(self.ffn_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
