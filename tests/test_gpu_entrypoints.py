"""``bench.py`` and ``chip_smoke.py``: both measure or check the GPU and
refuse any other backend (no result line, non-zero exit); their result
lines carry the device fields; the smoke's numpy references agree with
the pipelines on a small experiment on the CPU backend."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def _run(args, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _json_lines(text):
    return [ln for ln in text.splitlines() if ln.lstrip().startswith("{")]


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_cpu_backend(script):
    p = _run([os.path.join(REPO, script)])
    assert p.returncode != 0, p.stdout
    assert "no GPU" in p.stderr
    assert not _json_lines(p.stdout), p.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repo, the smoke has nothing to drive: it must
    fail and print no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert p.returncode != 0
    assert not _json_lines(p.stdout), p.stdout


class _FakeDevice:
    platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"


def test_bench_json_line_carries_device_fields(monkeypatch):
    monkeypatch.setattr(bench, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 400.00 W")
    d = json.loads(bench._json_line(
        12.5, **bench.device_fields([_FakeDevice()] * 4)))
    assert d["metric"] == "intensity_e2e_throughput" and d["value"] == 12.5
    assert d["platform"] == "gpu"
    assert d["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert d["device_count"] == 4
    assert d["card"] == "NVIDIA H100 80GB HBM3, 400.00 W"


def test_chip_smoke_last_line_carries_device_fields(monkeypatch, capsys):
    """With every phase stubbed, the smoke's result line is exactly the
    contract object, and a failing phase leaves no result line."""
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: [_FakeDevice()])
    for name in ("phase_native", "phase_data", "phase_intensity",
                 "phase_fret", "phase_segmentation"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}

    def boom(*a, **k):
        raise AssertionError("phase failed")

    monkeypatch.setattr(chip_smoke, "phase_fret", boom)
    with pytest.raises(AssertionError):
        chip_smoke.main([])
    assert not _json_lines(capsys.readouterr().out)


def test_synthetic_polygons_are_whole_pixel():
    polys = bench.synthetic_polygons()
    assert len(polys) == bench.N_ROIS
    for p in polys:
        assert p.shape == (24, 2)
        np.testing.assert_array_equal(p, np.round(p))


@pytest.fixture(scope="module")
def small_experiment(tmp_path_factory):
    """Two stages of the bench experiment at a reduced frame size (the
    ROI grid needs ~1620 x 820 px)."""
    d = str(tmp_path_factory.mktemp("exp"))
    bench._make_dataset(d, n_stages=2, h=832, w=1632)
    return d


def test_intensity_reference_matches_pipeline(small_experiment, tmp_path,
                                              monkeypatch):
    from imageprocess_tpu.cli import main

    out = str(tmp_path / "out")
    assert main(["intensity", small_experiment, "--channels", "2", "3",
                 "--batched", "--out", out, "--lang", "en"]) == 0
    rows = chip_smoke._read_csv(os.path.join(out, "xls",
                                             "fluor_intensity_perROI.csv"))
    assert len(rows) == 2 * bench.N_ROIS
    shape = (832, 1632)
    for stage in ("S01", "S02"):
        srows = sorted((r for r in rows if r["stage"] == stage),
                       key=lambda r: int(r["roi"]))
        masks = chip_smoke._stage_masks(small_experiment, stage, shape)
        for ch in (2, 3):
            ref = chip_smoke.intensity_reference(small_experiment, stage, ch,
                                                 masks)
            for r, want in zip(srows, ref):
                for k, v in want.items():
                    assert chip_smoke._rel_err(float(r[f"ch{ch}_{k}"]),
                                               float(v)) <= 1e-4, (stage, k)


def test_fret_reference_matches_pipeline(small_experiment, tmp_path):
    from imageprocess_tpu.cli import main

    out = str(tmp_path / "out")
    assert main(["fret", small_experiment, "--donor-ch", "2",
                 "--acceptor-ch", "3", "--out", out, "--lang", "en"]) == 0
    rows = chip_smoke._read_csv(os.path.join(out, "xls",
                                             "fret_ratio_perROI.csv"))
    for stage in ("S01", "S02"):
        srows = sorted((r for r in rows if r["stage"] == stage),
                       key=lambda r: int(r["roi"]))
        masks = chip_smoke._stage_masks(small_experiment, stage, (832, 1632))
        ref = chip_smoke.fret_reference(small_experiment, stage, 2, 3, masks)
        assert len(srows) == len(ref)
        got = np.array([float(r["ratio_mean"]) for r in srows])
        np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke on a GPU (skips elsewhere)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    assert chip_smoke.main([]) == 0
