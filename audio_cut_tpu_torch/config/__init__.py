from audio_cut_tpu_torch.config.manager import (
    ConfigManager,
    get_config,
    get_config_manager,
    get_runtime_override_keys,
    reset_runtime_config,
    set_runtime_config,
)

__all__ = [
    "ConfigManager",
    "get_config",
    "get_config_manager",
    "set_runtime_config",
    "reset_runtime_config",
    "get_runtime_override_keys",
]
