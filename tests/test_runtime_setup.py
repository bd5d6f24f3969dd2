"""Process-level setup: where the compile cache goes, what the tables and
segmentation paths import, and how the native decoder tier builds."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, env_overrides=None, drop=(), timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    for k in drop:
        env.pop(k, None)
    env.update(env_overrides or {})
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       env=env, capture_output=True, text=True,
                       timeout=timeout, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-1]


_CACHE_DIR = """
import imageprocess_tpu, jax
print(jax.config.jax_compilation_cache_dir)
"""


def test_compile_cache_honours_env(tmp_path):
    d = str(tmp_path / "cc")
    assert _python(_CACHE_DIR, {"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_compile_cache_defaults_inside_checkout():
    got = _python(_CACHE_DIR, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == os.path.join(REPO, ".jax_cache")
    import imageprocess_tpu

    assert imageprocess_tpu.DEFAULT_CACHE_DIR == got


def test_tables_and_segmentation_paths_skip_pillow_and_matplotlib(tmp_path):
    """With the native decoder loaded, a batched intensity run and the
    U-Net segmentation imports never touch Pillow or matplotlib (the card
    needs neither for them)."""
    import numpy as np

    from imageprocess_tpu.core import roiio
    from imageprocess_tpu.native import _load

    if _load() is None:
        pytest.skip("native decoder not built")
    # a 2-stage experiment written as raw u16 TIFFs by the test's own
    # Pillow, before the checked process starts
    from PIL import Image

    rng = np.random.default_rng(0)
    for s in (1, 2):
        for ch in (2, 3):
            img = rng.integers(100, 4000, (96, 128)).astype(np.uint16)
            Image.fromarray(img).save(str(tmp_path / f"S{s:02d}_{ch}.TIF"),
                                      format="TIFF", compression="tiff_lzw")
        sq = np.array([[10.0, 10.0], [50.0, 10.0], [50.0, 40.0], [10.0, 40.0]])
        roiio.save_roi_bundle(str(tmp_path / "roi" / f"S{s:02d}.json"),
                              f"S{s:02d}", (96, 128), [sq, sq + 30])
    out = _python(f"""
        import sys
        from imageprocess_tpu.cli import main
        import imageprocess_tpu.segment.auto, imageprocess_tpu.segment.cellseg
        rc = main(["intensity", {str(tmp_path)!r}, "--channels", "2", "3",
                   "--batched", "--out", {str(tmp_path / 'out')!r},
                   "--lang", "en"])
        assert rc == 0
        print(sorted(m for m in ("PIL", "matplotlib", "flax")
                     if m in sys.modules))
    """)
    assert out == "[]"


def test_native_library_stale_when_source_newer(tmp_path, monkeypatch):
    from imageprocess_tpu import native

    src, lib = tmp_path / "tiff_lzw.cpp", tmp_path / "libiptiff.so"
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    src.write_text("// source\n")
    assert native._stale()                      # no library yet
    lib.write_bytes(b"")
    os.utime(src, (1_000_000, 1_000_000))
    os.utime(lib, (2_000_000, 2_000_000))
    assert not native._stale()                  # library newer than source
    os.utime(src, (3_000_000, 3_000_000))
    assert native._stale()                      # source edited since


def test_native_build_failure_reports_compiler_stderr(tmp_path, monkeypatch):
    import shutil

    from imageprocess_tpu import native

    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "tiff_lzw.cpp"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "libiptiff.so"))
    monkeypatch.setattr(native, "build_error", None)
    with pytest.warns(RuntimeWarning, match="native TIFF decoder unavailable"):
        native._try_build()
    assert "error" in native.build_error
    assert "tiff_lzw.cpp" in native.build_error
    assert not (tmp_path / "libiptiff.so").exists()
