"""Model architecture configs and named presets (a copy of the JAX
package's ``models/config.py``, so a preset name means the same model to
both packages)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency scaling (HF ``rope_scaling`` block).

    ``llama3`` — Llama-3.1-style per-frequency-band scaling (long
    wavelengths divided by ``factor``, short ones untouched, smooth
    interpolation between ``low_freq_factor``/``high_freq_factor`` bands of
    the ``original_max_seq`` context). ``linear`` — uniform position
    interpolation (every frequency divided by ``factor``).
    """
    rope_type: str = "llama3"      # "llama3" | "linear"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_seq: int = 8192

    def __post_init__(self):
        if self.rope_type not in ("llama3", "linear"):
            raise ValueError(
                f"unsupported rope_scaling type {self.rope_type!r}; "
                f"supported: llama3, linear")


@dataclass(frozen=True)
class ModelConfig:
    family: str = "llama"          # "llama" | "qwen2" | "gemma" | "mixtral"
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    d_ff: int = 5632
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    rms_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    # QKV projection bias (Qwen2-family); the rest of the block is llama.
    attn_bias: bool = False
    # Gemma-family block variations (all config-driven — the llama forward
    # is the single implementation):
    act: str = "silu"              # MLP gate activation: "silu" | "gelu_tanh"
    rms_offset: float = 0.0        # RMSNorm weight offset: x * (offset + w)
    scale_embed: bool = False      # multiply embeddings by sqrt(d_model)
    # Explicit head dim for families where H * Dh != d_model (Gemma-7B:
    # 16 heads x 256 vs d_model 3072). 0 = derive d_model // n_heads.
    head_dim_override: int = 0
    # Sliding-window attention (mistral-family): position i attends keys
    # j with i - j < window (self included). 0 = full causal attention.
    sliding_window: int = 0
    # MoE (mixtral) fields
    n_experts: int = 0             # 0 → dense
    experts_per_token: int = 2

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


PRESETS: dict[str, ModelConfig] = {
    # Tiny model for tests: fast to init on CPU.
    "tiny-test": ModelConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256),
    "tiny-test-1k": ModelConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=1024),
    "tiny-qwen-test": ModelConfig(
        family="qwen2", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, max_seq_len=256, tie_embeddings=True,
        attn_bias=True),
    "tiny-gemma-test": ModelConfig(
        family="gemma", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=1, d_ff=128, max_seq_len=256, tie_embeddings=True,
        act="gelu_tanh", rms_offset=1.0, scale_embed=True,
        head_dim_override=16, rms_eps=1e-6),
    "tiny-moe-test": ModelConfig(
        family="mixtral", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, max_seq_len=256, n_experts=4,
        experts_per_token=2),
    # TinyLlama-1.1B (HF: TinyLlama/TinyLlama-1.1B-Chat-v1.0).
    "tinyllama-1.1b": ModelConfig(
        vocab_size=32000, d_model=2048, n_layers=22, n_heads=32, n_kv_heads=4,
        d_ff=5632, rope_theta=10000.0, max_seq_len=2048),
    # Qwen2-0.5B (HF: Qwen/Qwen2-0.5B-Instruct) — llama block + QKV bias,
    # tied embeddings.
    "qwen2-0.5b": ModelConfig(
        family="qwen2", vocab_size=151936, d_model=896, n_layers=24,
        n_heads=14, n_kv_heads=2, d_ff=4864, rope_theta=1000000.0,
        rms_eps=1e-6, max_seq_len=32768, tie_embeddings=True,
        attn_bias=True),
    # ~3B-class llama geometry (head_dim 128, GQA 24/8).
    "llama-3b-class": ModelConfig(
        vocab_size=32000, d_model=3072, n_layers=28, n_heads=24,
        n_kv_heads=8, d_ff=8192, rope_theta=10000.0, max_seq_len=2048),
    # Mistral-7B-v0.1 (HF: mistralai/Mistral-7B-Instruct-v0.1): llama
    # block + 4096-token sliding-window attention over a 32k context.
    "mistral-7b": ModelConfig(
        vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, rope_theta=10000.0, max_seq_len=32768,
        sliding_window=4096),
    # Phi-3-mini-4k (HF: microsoft/Phi-3-mini-4k-instruct): llama block,
    # MHA, sliding window 2047.
    "phi-3-mini": ModelConfig(
        vocab_size=32064, d_model=3072, n_layers=32, n_heads=32,
        n_kv_heads=32, d_ff=8192, rope_theta=10000.0, max_seq_len=4096,
        sliding_window=2047),
    # Tiny sliding-window model for tests (window << max_seq).
    "tiny-mistral-test": ModelConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=128, max_seq_len=256, sliding_window=16),
    # Llama-3-8B (HF: meta-llama/Meta-Llama-3-8B-Instruct).
    "llama-3-8b": ModelConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14336, rope_theta=500000.0, max_seq_len=8192),
    # Llama-3-70B.
    "llama-3-70b": ModelConfig(
        vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
        n_kv_heads=8, d_ff=28672, rope_theta=500000.0, max_seq_len=8192),
    # Gemma-2B (HF: google/gemma-2b): MQA (1 KV head), head_dim 256,
    # GeGLU MLP, (1+w) RMSNorm, sqrt(D)-scaled tied embeddings.
    "gemma-2b": ModelConfig(
        family="gemma", vocab_size=256000, d_model=2048, n_layers=18,
        n_heads=8, n_kv_heads=1, d_ff=16384, rope_theta=10000.0,
        rms_eps=1e-6, max_seq_len=8192, tie_embeddings=True,
        act="gelu_tanh", rms_offset=1.0, scale_embed=True,
        head_dim_override=256),
    # Gemma-7B (HF: google/gemma-7b): 16 heads x 256 > d_model 3072.
    "gemma-7b": ModelConfig(
        family="gemma", vocab_size=256000, d_model=3072, n_layers=28,
        n_heads=16, n_kv_heads=16, d_ff=24576, rope_theta=10000.0,
        rms_eps=1e-6, max_seq_len=8192, tie_embeddings=True,
        act="gelu_tanh", rms_offset=1.0, scale_embed=True,
        head_dim_override=256),
    # Mixtral-8x7B (HF: mistralai/Mixtral-8x7B-Instruct-v0.1).
    "mixtral-8x7b": ModelConfig(
        family="mixtral", vocab_size=32000, d_model=4096, n_layers=32,
        n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=1000000.0,
        max_seq_len=32768, n_experts=8, experts_per_token=2),
}


def get_preset(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]
