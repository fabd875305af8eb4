from .defaults import DEFAULTS, SettingsView

__all__ = ["DEFAULTS", "SettingsView"]
