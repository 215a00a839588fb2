"""The port's flag registry (ray_tpu_torch/core/config.py) against the
reference's, on the CPU.

The serving knobs `spec_overlap` and `kv_frame_layout` are declared in
both registries and read where the reference reads them, so one
environment, or one `init(system_config=)`, configures both packages: the
layout the engine streams a request's KV frames in
(`InferenceEngine._kv_layout`) and whether a draft-mode `SpecDecoder`
overlaps its propose (`SpecDecoder.overlap`) are the reference's under
each setting. The registries differ only by the flags of modules that wait
for later slices, and `describe_flags` has the reference's shape.
"""

import importlib
import types

import pytest

import ray_tpu
import ray_tpu.core.memory_monitor  # noqa: F401 — declares its flags
import ray_tpu.serve.engine as jengine
import ray_tpu.serve.spec_decode as jspec
import ray_tpu.util.profiler  # noqa: F401 — declares its flags
import ray_tpu_torch
import ray_tpu_torch.core.memory_monitor  # noqa: F401
import ray_tpu_torch.serve.engine as tengine
import ray_tpu_torch.serve.spec_decode as tspec
import ray_tpu_torch.util.profiler  # noqa: F401
from _torch_fixtures import _fresh_metric_registries  # noqa: F401
from ray_tpu.serve.config import SpeculationConfig as JSpeculationConfig
from ray_tpu_torch.serve.config import SpeculationConfig

# the modules, not the Config objects their packages' core/__init__ export
jconfig = importlib.import_module("ray_tpu.core.config")
tconfig = importlib.import_module("ray_tpu_torch.core.config")
THREAD_MODE = {"worker_processes": 0, "actor_processes": False}

# the reference's flags whose modules wait for later slices: host
# collectives (ROADMAP A5c, third slice) and the pipeline trainer (A7b)
WAITING = {
    "gang_barrier_timeout_ms",
    "pipeline_overlap_grad_exchange", "pipeline_virtual_stages", "stage_mesh_axes",
}


class _Prefetching:
    """A draft proposer that supports the overlapped propose, standing in
    for the draft model (SpecDecoder reads only `supports_prefetch`)."""

    supports_prefetch = True

    def __init__(self, engine, spec, draft_params=None):
        pass


@pytest.fixture
def clean():
    for api in (ray_tpu, ray_tpu_torch):
        api.shutdown()
    yield
    for api in (ray_tpu, ray_tpu_torch):
        api.shutdown()
    jconfig.config.reset()
    tconfig.config.reset()


def _set(how, monkeypatch, flags):
    """Apply `flags` to both packages by environment or through init()."""
    if how == "env":
        for name, value in flags.items():
            monkeypatch.setenv(f"RAY_TPU_{name.upper()}", str(value).lower())
        return
    ray_tpu.init(num_cpus=1, system_config=dict(flags, worker_processes=0))
    ray_tpu_torch.init(num_cpus=1, system_config=dict(flags, **THREAD_MODE))


def _overlap(spec_mod, monkeypatch, spec_cls, overlap=None):
    monkeypatch.setattr(spec_mod, "DraftModelProposer", _Prefetching)
    if hasattr(spec_mod.SpecDecoder, "_build_verify"):  # the reference jits here
        monkeypatch.setattr(spec_mod.SpecDecoder, "_build_verify", lambda self: None)
    return spec_mod.SpecDecoder(None, spec_cls(mode="draft", overlap=overlap)).overlap


def _layout(engine_mod, request_layout=""):
    req = types.SimpleNamespace(kv_frame_layout=request_layout)
    return engine_mod.InferenceEngine._kv_layout(None, req)


@pytest.mark.parametrize("how", ["env", "system_config"])
@pytest.mark.parametrize("layout", ["token", "layer", "bogus"])
def test_kv_frame_layout_configures_both_packages(clean, monkeypatch, how, layout):
    _set(how, monkeypatch, {"kv_frame_layout": layout})
    assert tconfig.config.kv_frame_layout == jconfig.config.kv_frame_layout == layout
    # the engine's resolution: the knob, unknown -> "layer"; a request's own wins
    assert _layout(tengine) == _layout(jengine) == (layout if layout != "bogus" else "layer")
    for own in ("token", "layer"):
        assert _layout(tengine, own) == _layout(jengine, own) == own


@pytest.mark.parametrize("how", ["env", "system_config"])
@pytest.mark.parametrize("overlap", [False, True])
def test_spec_overlap_configures_both_packages(clean, monkeypatch, how, overlap):
    _set(how, monkeypatch, {"spec_overlap": overlap})
    assert tconfig.config.spec_overlap is jconfig.config.spec_overlap is overlap
    got = _overlap(tspec, monkeypatch, SpeculationConfig)
    want = _overlap(jspec, monkeypatch, JSpeculationConfig)
    assert got is want is overlap
    # SpeculationConfig.overlap overrides the knob in both
    assert (_overlap(tspec, monkeypatch, SpeculationConfig, not overlap)
            is _overlap(jspec, monkeypatch, JSpeculationConfig, not overlap) is (not overlap))


def test_defaults_are_the_references(clean):
    for name in ("spec_overlap", "kv_frame_layout", "log_to_driver", "flight_recorder_entries",
                 "flight_recorder_bytes", "control_plane_snapshot_interval_s", "sanitize",
                 "sanitize_hold_ms"):
        assert tconfig.config.get(name) == jconfig.config.get(name), name
        assert tconfig._REGISTRY[name].doc == jconfig._REGISTRY[name].doc, name


def test_registry_differs_only_by_the_waiting_flags():
    jnames, tnames = set(jconfig._REGISTRY), set(tconfig._REGISTRY)
    assert jnames - tnames == WAITING
    assert tnames - jnames == set()


def test_describe_flags_has_the_references_shape(clean, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SANITIZE_HOLD_MS", "25")
    got, want = tconfig.describe_flags(), jconfig.describe_flags()
    assert set(got) == set(want) - WAITING
    for name, row in got.items():
        assert set(row) == {"default", "doc", "value"}
        if name != "object_store_fallback_dir":  # the port spills beside its own session
            assert row["default"] == want[name]["default"], name
            assert row["value"] == want[name]["value"], name
    assert got["sanitize_hold_ms"]["value"] == 25.0


def test_an_unknown_flag_still_raises_in_both(clean):
    for cfg in (tconfig.config, jconfig.config):
        with pytest.raises(KeyError, match="unknown config flag"):
            cfg.apply_overrides({"no_such_flag": 1})
