"""`imageprocess doctor` — environment self-check.

The backend/mesh probes run in subprocesses under timeouts, so a backend
that fails or never answers is reported, and the doctor itself returns.
"""

import os

import pytest

from imageprocess_tpu.utils.doctor import run_doctor, _run_sub


@pytest.fixture
def cpu_backend_env(monkeypatch):
    monkeypatch.setenv("IP_DOCTOR_BACKEND", "cpu")


def test_doctor_all_green(cpu_backend_env):
    lines = []
    rc = run_doctor(backend_timeout=240.0, log=lines.append)
    assert rc == 0, lines
    joined = "\n".join(lines)
    for name in ("deps", "native", "numerics", "write", "backend", "mesh"):
        assert f"[ok] {name}" in joined, joined
    assert lines[-1] == "all checks passed"


def test_doctor_skip_backend(cpu_backend_env):
    lines = []
    rc = run_doctor(backend_timeout=240.0, skip_backend=True,
                    log=lines.append)
    assert rc == 0, lines
    assert any(line.startswith("[skip] backend") for line in lines)


def test_doctor_hung_probe_is_killed_not_waited():
    """A probe that never returns must be reported as hung within the
    timeout, not block the doctor."""
    import time

    t0 = time.monotonic()
    ok, detail = _run_sub("import time\ntime.sleep(600)\nprint('x')",
                          timeout=3.0)
    assert not ok
    assert "hung" in detail
    assert time.monotonic() - t0 < 30


def test_doctor_failing_probe_reports_error():
    ok, detail = _run_sub("raise RuntimeError('boom')", timeout=30.0)
    assert not ok
    assert "boom" in detail


def test_doctor_cli_exit_code(cpu_backend_env, capsys):
    from imageprocess_tpu.cli import main

    rc = main(["doctor", "--backend-timeout", "240", "--lang", "en"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "all checks passed" in out


def test_doctor_json_output(cpu_backend_env, capsys):
    from imageprocess_tpu.cli import main
    import json

    rc = main(["doctor", "--backend-timeout", "240", "--json", "--lang", "en"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("{"))
    d = json.loads(line)
    assert rc == 0 and d["ok"] and d["failures"] == 0
    assert set(d["checks"]) == {"deps", "native", "numerics", "write",
                                "backend", "mesh"}
    assert all(v["status"] == "ok" for v in d["checks"].values())
