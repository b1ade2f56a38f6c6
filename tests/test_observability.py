"""Aux subsystems: profiling roofline, checkify sanitizer, multi-host
init wrapper, global mesh (SURVEY.md §5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from computeraytracer.parallel import distributed, mesh as mesh_mod
from computeraytracer.scene import presets, scene_from_dict
from computeraytracer.tracer import xla as xla_tracer
from computeraytracer.utils import debug, profiling


H100 = profiling.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]


def test_roofline_sane():
    r = profiling.roofline(1024, 1024, 1, 8, 18, H100, mean_depth=3.0)
    assert r.flops > 0 and r.hbm_bytes > 0
    assert r.bound == "compute"  # path tracing is f32-compute-bound
    assert r.sol_s == max(r.sol_compute_s, r.sol_memory_s)
    # measured time worse than speed of light -> fraction < 1
    assert 0 < r.fraction(r.sol_s * 10) < 1
    assert r.to_dict()["intensity"] == pytest.approx(r.intensity)


def test_roofline_backward_costs_more():
    fwd = profiling.roofline(256, 256, 1, 4, 18, H100)
    bwd = profiling.roofline(256, 256, 1, 4, 18, H100, backward=True)
    assert bwd.flops > fwd.flops


class _FakeDevice:
    def __init__(self, kind):
        self.device_kind = kind


def test_device_peaks_h100():
    """The H100 SXM entry carries the published f32 and HBM peaks."""
    p = profiling.device_peaks(_FakeDevice("NVIDIA H100 80GB HBM3"))
    assert (p.f32_tflops, p.hbm_gbs) == (67.0, 3350.0)
    assert "H100" in p.source
    r = profiling.roofline(1024, 1024, 1, 8, 18, p)
    assert r.sol_compute_s == pytest.approx(r.flops / 67e12)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_device_peaks_refuses_unknown(kind):
    """A device without a table entry is an error, never a default."""
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.device_peaks(_FakeDevice(kind))


def test_device_peaks_refuses_cpu_backend():
    with pytest.raises(KeyError):
        profiling.device_peaks()


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "xprof")
    with profiling.trace(logdir):
        with profiling.annotate("tiny-matmul"):
            x = jnp.ones((8, 8)) @ jnp.ones((8, 8))
            jax.block_until_ready(x)
    files = list((tmp_path / "xprof").rglob("*"))
    assert any(f.is_file() for f in files), "no trace artifacts written"


def test_checked_clean_render_passes():
    scene, _ = scene_from_dict(presets.cornell_box(8, 8))
    fn = debug.checked(
        lambda s: xla_tracer.render_sample(s, 8, 8, 1, max_depth=2,
                                           use_remat=False))
    img = fn(scene)
    assert np.isfinite(np.asarray(img)).all()


def test_checked_catches_nan():
    from jax.experimental import checkify

    scene, _ = scene_from_dict(presets.cornell_box(8, 8))
    bad = scene._replace(
        spectra=jnp.asarray(scene.spectra).at[0, 0].set(jnp.nan))
    fn = debug.checked(
        lambda s: xla_tracer.render_sample(s, 8, 8, 1, max_depth=2,
                                           use_remat=False))
    with pytest.raises(checkify.JaxRuntimeError):
        fn(bad)


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    assert distributed.initialize() is False  # single host: no-op


def test_global_mesh_spans_all_devices():
    m = distributed.global_mesh()
    assert m.shape[mesh_mod.DP_AXIS] * m.shape[mesh_mod.SP_AXIS] == len(
        jax.devices())
    m1 = distributed.global_mesh(sp=1)
    assert m1.shape[mesh_mod.SP_AXIS] == 1
