from .defaults import DEFAULTS, SettingsView
from .metaparse import format_value, parse_value
from .registry import (
    AccessLevel,
    Parameter,
    Settings,
    global_settings,
    reset_global_settings,
    set_setting,
    setting,
)
from .settings_io import (
    apply_dict,
    load_layered,
    load_settings_file,
    parse_settings_text,
    settings_to_text,
    write_settings_file,
)

__all__ = [
    "DEFAULTS", "SettingsView",
    "AccessLevel", "Parameter", "Settings", "global_settings",
    "reset_global_settings", "set_setting", "setting",
    "parse_value", "format_value",
    "apply_dict", "load_layered", "load_settings_file",
    "parse_settings_text", "settings_to_text", "write_settings_file",
]
