"""The port's settings registry (trex_tpu_torch/config/) against the JAX
package's: the parameter table, value parsing and formatting, settings
files, deprecations, and the engines' DEFAULTS. Everything here is
exact: parsed values, defaults and provenance compare with ==."""
import numpy as np
import pytest

from trex_tpu.config import metaparse as jax_meta
from trex_tpu.config import registry as jax_registry
from trex_tpu.config import settings_io as jax_io
from trex_tpu_torch.config import (DEFAULTS, AccessLevel, Settings,
                                   SettingsView, apply_dict, format_value,
                                   load_settings_file, parse_value,
                                   settings_to_text)
from trex_tpu_torch.config import registry as port_registry

# the cases of tests/test_config.py::test_meta_value_roundtrip, and more
VALUES = [True, False, 12, 0.5, "fish", [1, 2, 3], [[70, 420]],
          {"a": 1, "b": [2, 3]}, "", -7, 1e-7, 3.0, [0.25, -1.5],
          {"0": [1, 2]}, [["X", ["wcentroid"]], ["blobid", []]], None]
TEXTS = ["true", "false", "12", "-3", "0.5", "1e-3", "'fish'", '"fish"',
         "fish", "[1,2,3]", "[[70, 420]]", "{'a':1,'b':[2,3]}", "[]", "{}",
         "null", "[[0.1,0.2],[0.3,0.4]]", "  42  ", "[a, b]", "-inf", "nan"]

SETTINGS_TEXT = """\
# a comment
// another comment
track_max_individuals = 8
track_threshold = 12
threshold_constant = 13
number_fish = 9
detect_size_filter = [[1,10000]]
individual_prefix = "fish"
output_fields = [["X",["wcentroid"]],["SPEED",["wcentroid"]],["blobid",[]]]
track_threshold_is_absolute = false
cm_per_pixel = 0.05
recognition_enable = true
not_a_parameter = 5
meta_source_path = "/tmp/x.mp4"
version = "9"
"""


def _params(reg):
    s = reg.Settings()
    return {n: (p.type, p.default, int(p.access), p.category, p.doc)
            for n, p in s._params.items()}, s._deprecations


def test_parameter_table_equals_jax():
    """Every parameter's type, default, access level, category and doc,
    the framework parameters (track_engine, detect_engine) included,
    and the deprecation table."""
    port, port_dep = _params(port_registry)
    ref, ref_dep = _params(jax_registry)
    assert port == ref
    assert port_dep == ref_dep
    assert port["track_engine"][1] == "auto"
    assert port["detect_engine"][1] == "host"
    assert len(port) >= 374


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_format_and_round_trip_equal_jax(i):
    v = VALUES[i]
    text = format_value(v)
    assert text == jax_meta.format_value(v)
    got = parse_value(text)
    want = jax_meta.parse_value(text)
    assert repr(got) == repr(want)
    if v is not None:
        assert got == v


@pytest.mark.parametrize("text", TEXTS)
def test_parse_value_equals_jax(text):
    got, want = parse_value(text), jax_meta.parse_value(text)
    if isinstance(want, float) and np.isnan(want):
        assert isinstance(got, float) and np.isnan(got)
    else:
        assert repr(got) == repr(want)


def test_settings_file_loads_to_the_same_values_and_provenance(tmp_path):
    path = tmp_path / "t.settings"
    path.write_text(SETTINGS_TEXT)
    port, ref = Settings(), jax_registry.Settings()
    got = load_settings_file(port, path)
    want = jax_io.load_settings_file(ref, path)
    assert got == want
    assert port.to_dict() == ref.to_dict()
    for name in ref.names():
        assert port.source_of(name) == ref.source_of(name), name
    assert port["track_threshold"] == 13  # threshold_constant, later
    assert port["track_max_individuals"] == 9  # number_fish, later
    assert port.source_of("version") == "default"  # SYSTEM: refused
    assert settings_to_text(port) == jax_io.settings_to_text(ref)
    # apply_dict, as the track task applies pv metadata
    meta = {"frame_rate": "30", "meta_build": "x", "track_max_speed": 80}
    assert apply_dict(port, dict(meta), source="pv-metadata") \
        == jax_io.apply_dict(ref, dict(meta), source="pv-metadata")
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("old", sorted(
    jax_registry.Settings()._deprecations)[:40])
def test_deprecation_migration_equals_jax(old):
    port, ref = Settings(), jax_registry.Settings()
    new = ref._deprecations[old]
    value = ref[new] if new else 1
    if new and isinstance(value, bool):
        value = not value
    port.set(old, value)
    ref.set(old, value)
    assert port.to_dict() == ref.to_dict()
    assert port.has(old) == ref.has(old)
    assert port.get(old, "absent") == ref.get(old, "absent")


def test_access_levels_equal_jax():
    for reg in (port_registry, jax_registry):
        s = reg.Settings()
        with pytest.raises(PermissionError):
            s.set("version", "x", max_access=reg.AccessLevel.PUBLIC)
    assert [int(a) for a in AccessLevel] \
        == [int(a) for a in jax_registry.AccessLevel]


def test_defaults_equal_the_table():
    """DEFAULTS (the values the engines fall back to) equal the
    registry's defaults, type included, for every key it holds."""
    s = Settings()
    for key, value in DEFAULTS.items():
        assert key in s, key
        assert s[key] == value and type(s[key]) is type(value), key


def test_settings_view_reads_a_registry_unchanged():
    """The engines' SettingsView over a registry Settings reads the
    registry's values, and an engine takes the registry directly."""
    from trex_tpu_torch.track.engine import FastTracker

    s = Settings()
    s.set("track_max_individuals", 3)
    s.set("track_background_subtraction", True)
    s.set("track_threshold", 20)
    view = SettingsView(s)
    assert view["track_max_individuals"] == 3
    for key in DEFAULTS:
        assert view[key] == s[key]
    tr = FastTracker(s, np.full((16, 16), 200, np.uint8))
    assert tr.settings["track_max_individuals"] == 3
