"""Model families. The engine asks for (init, forward) by
ModelConfig.family so new architectures plug in without engine changes."""
from .config import PRESETS, ModelConfig, get_preset


def forward_fn(config: ModelConfig):
    """The forward callable for a family: (params, config, tokens, lengths,
    cache, *, attention_fn, active=None) → (logits, cache)."""
    if config.is_moe:
        from . import mixtral
        return mixtral.forward
    from . import llama
    return llama.forward


def init_fn(config: ModelConfig):
    """Random-init callable for a family: (config, generator, dtype,
    device, quant) → params."""
    if config.is_moe:
        from . import mixtral
        return mixtral.init_params
    from . import llama
    return llama.init_params


__all__ = ["ModelConfig", "PRESETS", "get_preset", "forward_fn", "init_fn"]
