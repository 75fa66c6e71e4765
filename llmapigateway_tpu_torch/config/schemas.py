"""Pydantic schemas for the two config files (a copy of the JAX
package's ``config/schemas.py`` with the same fields and defaults, so a
``providers.json`` means the same thing to both packages).

``providers.json`` is a list of single-key dicts name→details;
``models_fallback_rules.json`` a list of rule objects. A provider with
``type: "local"`` is an in-process engine:

    { "local_gpu": { "type": "local", "engine": { "preset": ..., ... } } }

The schema accepts every knob of the JAX package, so a file written for
either package validates against both. What the port has not ported yet is
refused where it would mean something here: engine knobs at engine build
(engine/engine.py ``_refuse_unported``), provider and rule knobs at config
load (config/loader.py ``refuse_unported``), each with a :class:`NotPorted`
error naming its ROADMAP item. A knob the JAX package itself treats as inert
for the configuration stays accepted, and so do the engine knobs that mean
nothing off the TPU (``compilation_cache_dir``, ``debug_nans``,
``prewarm_sampler_variants``, ``profile_annotations``).
"""
from __future__ import annotations

from typing import Any

from pydantic import BaseModel, ConfigDict, Field, field_validator


class ConfigError(Exception):
    """Raised on invalid configuration; callers decide whether to exit."""


class NotPorted(ConfigError, ValueError):
    """A knob set to a value whose feature the port does not have yet."""


def not_ported(knob: str, item: str) -> NotPorted:
    """The refusal of ``knob``, naming its ROADMAP.md Queue 1 ``item``."""
    return NotPorted(f"{knob} is not ported to the PyTorch engine yet "
                     f"(ROADMAP.md, port queue: {item})")


class DisaggregationConfig(BaseModel):
    """Prefill/decode disaggregation knobs (not ported: refused when
    ``enabled``)."""
    model_config = ConfigDict(extra="forbid")

    enabled: bool = False
    prefill_slots: int = Field(default=0, ge=0)
    admission: str = "goodput"

    @field_validator("admission")
    @classmethod
    def _admission_known(cls, v: str) -> str:
        if v not in ("goodput", "always"):
            raise ValueError(
                f"admission must be 'goodput' or 'always', got {v!r}")
        return v


class SupervisorConfig(BaseModel):
    """Engine supervision knobs (watchdog, restart budget, drain). The
    PyTorch engine refuses any value but these defaults until supervision
    is ported."""
    model_config = ConfigDict(extra="forbid")

    watchdog_ms: float = Field(default=0.0, ge=0.0)
    max_restarts: int = Field(default=3, ge=0)
    backoff_ms: float = Field(default=50.0, ge=0.0)
    backoff_max_ms: float = Field(default=5000.0, ge=0.0)
    drain_deadline_ms: float = Field(default=10000.0, gt=0.0)


class LocalEngineConfig(BaseModel):
    """Engine settings for a ``type: local`` provider entry: checkpoint or
    preset, batching and KV-cache geometry, and the feature knobs."""
    model_config = ConfigDict(extra="forbid")

    model_path: str = ""            # HF checkpoint dir (safetensors); "" → random init
    preset: str | None = None       # named config (e.g. "llama-3-8b") when no checkpoint
    dtype: str = "bfloat16"
    # Mesh geometry: axis name -> size.
    mesh: dict[str, int] = Field(default_factory=dict)
    max_batch_size: int = 8
    max_seq_len: int = 4096
    kv_layout: str = "paged"        # "paged" | "contiguous"
    # Tokens per KV page; a page is also the unit the paged kernels walk.
    kv_page_size: int = 256
    kv_num_pages: int = 0           # 0 → derived from max_batch_size*max_seq_len
    kv_pages_per_block: int = 1
    # Radix prefix cache over the paged pool (the JAX default is on; the
    # PyTorch engine refuses it until it is ported).
    prefix_cache: bool = True
    hbm_peak_gbps: float = 0.0
    prefill_chunk: int = 512
    # Max queued admissions prefilled in ONE forward call. 1 disables.
    prefill_batch: int = 8
    decode_burst: int = 8           # chained decode steps per host sync
    # Burst depth while new work is waiting (prefill interleave).
    decode_burst_busy: int = 4
    # Burst-depth cap from a TTFT target (refused when set: it belongs to the
    # compiled, pipelined decode step).
    ttft_target_ms: float = 0.0
    max_tokens_default: int = 1024
    spec_draft_len: int = 0
    spec_min_tokens_per_step: float = 1.2
    spec_probe_interval: int = 25
    spec_acceptance_floor: float = 0.0
    spec_wall_gate: bool = True
    quant: str = ""                 # "" | "int8" | "int4"
    kv_quant: str = ""              # "" | "int8"
    attention: str = "auto"         # "auto" | "pallas" | "reference"
    seq_attention: str = "ring"     # "ring" | "ulysses"
    tokenizer_path: str | None = None
    # XLA's compilation cache, NaN checks, sampler prewarming and profiler
    # annotations: no meaning off the TPU, accepted and inert here.
    compilation_cache_dir: str = ""
    prewarm_sampler_variants: bool = True
    debug_nans: bool = False
    flight_ring_size: int = 4096
    hbm_headroom_watermark: float = Field(default=0.0, ge=0.0, lt=1.0)
    profile_annotations: bool = True
    disaggregation: DisaggregationConfig = Field(
        default_factory=DisaggregationConfig)
    supervisor: SupervisorConfig = Field(default_factory=SupervisorConfig)


class BreakerSettings(BaseModel):
    """Per-provider circuit-breaker knobs. Breakers are not ported yet: an
    enabled breaker on a local provider is refused at config load."""
    model_config = ConfigDict(extra="forbid")

    enabled: bool = True
    window_s: float = Field(default=30.0, gt=0)
    min_requests: int = Field(default=5, ge=1)
    failure_threshold: float = Field(default=0.5, gt=0, le=1.0)
    cooldown_s: float = Field(default=15.0, gt=0)


class ProviderDetails(BaseModel):
    """One provider's connection/engine details. Unknown keys are accepted."""
    model_config = ConfigDict(extra="allow")

    type: str = "remote_http"       # "remote_http" | "local"
    baseUrl: str | None = None
    apikey: str | None = None       # env-var name, or the literal key itself
    engine: LocalEngineConfig | None = None
    breaker: BreakerSettings | None = None

    @field_validator("type")
    @classmethod
    def _check_type(cls, v: str) -> str:
        if v not in ("remote_http", "local"):
            raise ValueError(f"provider type must be 'remote_http' or 'local', got {v!r}")
        return v

    def validate_semantics(self, name: str) -> None:
        if self.type == "remote_http" and not self.baseUrl:
            raise ValueError(f"provider {name!r}: remote_http requires 'baseUrl'")
        if self.type == "local" and self.engine is None:
            raise ValueError(f"provider {name!r}: local provider requires 'engine' config")


class FallbackModelRule(BaseModel):
    """One target in a gateway model's fallback chain."""
    model_config = ConfigDict(extra="forbid")

    provider: str
    model: str
    use_provider_order_as_fallback: bool = False
    providers_order: list[str] | None = None
    retry_delay: float = 0.0
    retry_count: int = 0
    custom_body_params: dict[str, Any] | None = None
    custom_headers: dict[str, str] | None = None

    @field_validator("use_provider_order_as_fallback", mode="before")
    @classmethod
    def _coerce_bool(cls, v: Any) -> Any:
        if isinstance(v, str):
            return v.strip().lower() == "true"
        return v


class ModelFallbackConfig(BaseModel):
    """A gateway model: ordered fallback chain + rotation flag (the string
    ``"true"`` counts as true, as in the original gateway's files)."""
    model_config = ConfigDict(extra="forbid")

    gateway_model_name: str
    fallback_models: list[FallbackModelRule]
    rotate_models: bool = False
    timeout_ms: float = Field(default=0.0, ge=0)
    slo_ttft_ms: float = Field(default=0.0, ge=0)
    slo_tpot_ms: float = Field(default=0.0, ge=0)

    @field_validator("rotate_models", mode="before")
    @classmethod
    def _coerce_bool(cls, v: Any) -> Any:
        if isinstance(v, str):
            return v.strip().lower() == "true"
        return v
