"""utils (PNG io, metrics) and the CLI entry points."""

import json

import numpy as np
import pytest

from computeraytracer import cli
from computeraytracer.utils.image import read_png, to_u8, write_png
from computeraytracer.utils.metrics import RenderMeter


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0.0, 1.0, (13, 17, 3)).astype(np.float32)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    back = read_png(str(path))
    np.testing.assert_array_equal(back, to_u8(img))


def test_render_meter(tmp_path):
    log = tmp_path / "m.jsonl"
    m = RenderMeter(jsonl_path=str(log))
    m.start()
    rec = m.stop(paths=1000, step=1)
    assert rec["paths"] == 1000 and rec["step"] == 1
    assert m.total_paths == 1000
    assert json.loads(log.read_text())["paths"] == 1000


def test_cli_info(capsys):
    rc = cli.main(["info", "--preset", "cornell_box"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["primitives"] == out["patches"] + out["spheres"] + \
        out["triangles"]
    assert out["lights"] >= 1


def test_cli_render_xla(tmp_path, capsys):
    out = tmp_path / "img.png"
    rc = cli.main(["render", "--preset", "simple_scene", "--width", "16",
                   "--height", "16", "--spp", "1", "--depth", "2",
                   "--kernel", "xla", "--out", str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (16, 16, 3)
    assert img.max() > 0


def test_cli_render_progressive(tmp_path, capsys):
    """--progressive N rewrites --out every N samples and the final
    accumulated image equals a one-shot --spp render bit-for-bit
    (counter-based seeding: progressive chunks are a pure fold)."""
    out_p = tmp_path / "prog.png"
    rc = cli.main(["render", "--preset", "simple_scene", "--width", "16",
                   "--height", "16", "--spp", "4", "--depth", "2",
                   "--kernel", "xla", "--progressive", "2",
                   "--out", str(out_p)])
    assert rc == 0
    out_s = tmp_path / "shot.png"
    rc = cli.main(["render", "--preset", "simple_scene", "--width", "16",
                   "--height", "16", "--spp", "4", "--depth", "2",
                   "--kernel", "xla", "--out", str(out_s)])
    assert rc == 0
    a = read_png(str(out_p))
    b = read_png(str(out_s))
    import numpy as np
    # 8-bit PNGs: identical up to the accumulation-order half-ulp
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_cli_render_sharded_default_kernel(tmp_path, capsys):
    """--sharded runs with the default --kernel, one-shot and
    progressive, over the 8-device CPU mesh; both images agree."""
    import numpy as np

    common = ["render", "--preset", "simple_scene", "--width", "16",
              "--height", "16", "--spp", "4", "--depth", "2", "--sharded"]
    out_s = tmp_path / "shot.png"
    assert cli.main(common + ["--out", str(out_s)]) == 0
    out_p = tmp_path / "prog.png"
    assert cli.main(common + ["--progressive", "2",
                              "--out", str(out_p)]) == 0
    a = read_png(str(out_p))
    b = read_png(str(out_s))
    assert b.shape == (16, 16, 3) and b.max() > 0
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_former_package_name_aliases_modules():
    """The package's former import name (the alias package beside it)
    reaches the same module objects, and `python -m` on it runs the
    CLI."""
    import importlib
    import os
    import pathlib
    import pkgutil
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    aliases = [m.name for m in pkgutil.iter_modules([str(root)])
               if m.name.startswith("computeraytracer_")]
    assert aliases
    for name in aliases:
        assert (importlib.import_module(name + ".tracer.api")
                is importlib.import_module("computeraytracer.tracer.api"))
        out = subprocess.run(
            [sys.executable, "-m", name, "info", "--preset", "simple_scene"],
            capture_output=True, text=True, cwd=root, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout)["primitives"] == 4


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and sets
    no directory of its own."""
    import jax

    from computeraytracer.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import pathlib

    import jax

    from computeraytracer.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    root = pathlib.Path(__file__).resolve().parents[1]
    assert path == str(root / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_cpu(capsys):
    """chip_smoke.py exits nonzero, printing no result, without a GPU."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit) as e:
        mod.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
