"""Removed settings are refused, the compile-cache placement, the native
library's host key and the device helpers."""

import os

import numpy as np
import pytest

import jax

from silent_speech.core import config as C


@pytest.mark.parametrize("cfg_cls", [C.TrainConfig, C.InferConfig,
                                     C.CTCTrainConfig, C.EvalConfig])
def test_removed_kernel_settings_are_refused(cfg_cls):
    """A setting that chose a removed kernel fails loudly on the command
    line instead of being ignored or swapped for another path."""
    for knob in ("roi_impl=fused", "gru_impl=pallas", "roi_variant=tiled3"):
        with pytest.raises(AttributeError, match="has no field"):
            C.apply_overrides(cfg_cls(), [knob])


# --- compile cache -----------------------------------------------------------

@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """Unset: the cache goes to <repo>/build/jax_cache. Set: nothing is set
    in code (JAX reads the variable itself)."""
    from silent_speech.runtime import compile_cache as cc

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        got = cc.enable_compile_cache(str(tmp_path))
        want = os.path.join(str(tmp_path), "build", "jax_cache")
        assert got == want == cc.default_cache_dir(str(tmp_path))
        assert calls == [("jax_compilation_cache_dir", want)]
    else:
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / env_dir))
        assert cc.enable_compile_cache(str(tmp_path)) is None
        assert calls == []


def test_default_cache_dir_is_in_the_checkout():
    from silent_speech.runtime import compile_cache as cc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cc.default_cache_dir() == os.path.join(repo, "build", "jax_cache")


# --- native library host key ---------------------------------------------------

def test_host_key_changes_with_cpu_flags():
    from silent_speech.runtime import native

    a = native.host_key("x86_64", "avx2 sse4_2")
    assert a == native.host_key("x86_64", "avx2 sse4_2")
    assert a != native.host_key("x86_64", "avx2 avx512f sse4_2")
    assert a != native.host_key("aarch64", "avx2 sse4_2")


def test_cpu_flags_parsed_sorted(tmp_path):
    from silent_speech.runtime import native

    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nflags\t\t: sse4_2 avx2 fpu\n"
                    "processor\t: 1\nflags\t\t: other\n")
    assert native._cpu_flags(str(info)) == "avx2 fpu sse4_2"
    assert native._cpu_flags(str(tmp_path / "missing")) == ""


def test_lib_path_carries_host_key(monkeypatch):
    """A library built on another host has another name, so a copied
    build/ directory rebuilds instead of loading foreign code."""
    from silent_speech.runtime import native

    here = native.lib_path()
    assert native.host_key() in os.path.basename(here)
    monkeypatch.setattr(native, "_cpu_flags", lambda: "some other cpu")
    assert native.lib_path() != here


# --- device helpers -------------------------------------------------------------

def test_require_gpu_refuses_the_cpu():
    from silent_speech.runtime.device import device_info, require_gpu

    info = device_info()
    assert set(info) == {"platform", "kind", "count"}
    assert info["platform"] == "cpu" and info["count"] >= 1
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


def test_card_info_without_nvidia_smi(monkeypatch):
    from silent_speech.runtime import device

    monkeypatch.setattr(device, "NVIDIA_SMI_QUERY",
                        ["definitely-not-a-binary-on-path"])
    assert device.card_info().startswith("nvidia-smi unavailable")


def test_bench_refuses_the_cpu(monkeypatch):
    """bench.py prints no result without a GPU."""
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(repo, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit, match="no GPU"):
        mod.main()
    assert np.isfinite(mod.BASELINE_CLIPS_PER_SEC)
