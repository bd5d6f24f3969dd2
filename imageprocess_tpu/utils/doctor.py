"""Environment self-check (``imageprocess doctor``).

A deployment aid the reference toolkit lacks: one line per check of the
host tier, the numerics and the JAX backend.  The backend and mesh checks
run in a subprocess under a timeout, so the doctor reports a failed or
stuck backend instead of failing with it.

Checks:
  deps       import + version of the scientific stack
  native     C++ TIFF tier builds/loads; LZW+deflate decode bit-exact vs PIL
  numerics   exact (k, g) percentile and rasterizer edge-rule micro-oracles
  write      tmp-dir atomic write/replace
  backend    jax backend init + one dispatch (platform, device_kind),
             under --backend-timeout
  mesh       virtual 4-device CPU mesh + psum (sharding machinery, no HW)

Exit status: 0 when every run check passes, 1 otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Callable, List, Tuple

_OK, _FAIL, _SKIP = "[ok]", "[FAIL]", "[skip]"


def _run_sub(code: str, timeout: float) -> Tuple[bool, str]:
    """Run a python snippet in a subprocess under a hard timeout.  Returns
    (ok, last_output_line_or_error)."""
    try:
        p = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return False, f"hung (no answer within {timeout:.0f}s) — killed"
    out = (p.stdout or "").strip().splitlines()
    if p.returncode == 0 and out:
        return True, out[-1]
    tail = (p.stderr or "").strip().splitlines()
    return False, tail[-1][:160] if tail else f"exit {p.returncode}"


def _check_deps() -> Tuple[bool, str]:
    import jax
    import numpy
    import optax
    import pandas
    import PIL
    import scipy

    return True, (
        f"numpy {numpy.__version__}, jax {jax.__version__}, "
        f"scipy {scipy.__version__}, optax {optax.__version__}, "
        f"pandas {pandas.__version__}, pillow {PIL.__version__}"
    )


def _check_native() -> Tuple[bool, str]:
    import time

    import numpy as np
    from PIL import Image

    from ..native import decode_tiff

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 65536, (512, 640)).astype(np.uint16)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.tif")
        Image.fromarray(arr).save(p, format="TIFF", compression="tiff_lzw")
        # untimed warm-up: the first call may include the one-time g++ build
        # of libiptiff.so — don't let that read as "0 Mpix/s decoder"
        if decode_tiff(p) is None:
            return False, "native decoder unavailable (build failed?)"
        t0 = time.perf_counter()
        got = decode_tiff(p)
        dt = time.perf_counter() - t0
        if got is None:
            return False, "native decoder unavailable (build failed?)"
        if not np.array_equal(got, arr):
            return False, "LZW decode mismatch vs PIL"
        # deflate path exercises the zlib link
        p2 = os.path.join(d, "t2.tif")
        Image.fromarray(arr).save(p2, format="TIFF",
                                  compression="tiff_adobe_deflate")
        got2 = decode_tiff(p2)  # the C++ tier's -lz link, exercised for real
        if got2 is None or not np.array_equal(got2, arr):
            return False, "deflate decode mismatch (zlib link?)"
    return True, f"LZW+deflate bit-exact vs PIL ({arr.size / dt / 1e6:.0f} Mpix/s single-frame)"


def _check_numerics() -> Tuple[bool, str]:
    import numpy as np

    from ..geom.rasterize import EdgeRule, rasterize_polygon_np
    from ..native import u16_percentile_strided
    from ..ops.percentile import p1000_of

    rng = np.random.default_rng(1)
    vals = rng.integers(0, 65536, (317, 317)).astype(np.uint16)
    for q in (1.0, 25.0, 99.5):
        want = np.percentile(vals.ravel().astype(np.float64), q)
        got = u16_percentile_strided(vals, 1, p1000_of(q))
        if abs(got - want) > 1e-9 * max(1.0, abs(want)):
            return False, f"percentile({q}) {got} != {want}"
    poly = np.array([[1.0, 1.0], [6.0, 1.0], [6.0, 5.0], [1.0, 5.0]])
    areas = {rule: int(rasterize_polygon_np(poly, (8, 8), rule=rule).sum())
             for rule in (EdgeRule.MPL, EdgeRule.PNPOLY)}
    # integer-corner rect: MPL includes both edges (6x4=24 at these
    # half-open thresholds), PNPOLY the half-open 5x4=20
    if areas[EdgeRule.MPL] != 24 or areas[EdgeRule.PNPOLY] != 20:
        return False, f"rasterizer edge rule drift ({areas})"
    return True, "exact percentile + both rasterizer edge rules"


def _check_write() -> Tuple[bool, str]:
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.txt")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            f.write("ok")
        os.replace(tmp, p)
        with open(p) as f:
            if f.read() != "ok":
                return False, "read-back mismatch"
    return True, "atomic write/replace"


def _backend_code(backend: str) -> str:
    force = (f"import jax; jax.config.update('jax_platforms', {backend!r})\n"
             if backend else "import jax\n")
    return (force +
            "import jax.numpy as jnp\n"
            "d = jax.devices()\n"
            "x = float(jnp.zeros(()) + 1.0)\n"
            "print(f'{d[0].platform} ({d[0].device_kind}) x{len(d)} — "
            "dispatch ok')\n")


_MESH_CODE = """
import os
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '') +
                           ' --xla_force_host_platform_device_count=4')
import jax
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np
devs = np.array(jax.devices()[:4])
assert len(devs) == 4, devs
mesh = Mesh(devs, ('b',))
x = jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P('b')))
s = float(jax.jit(lambda v: v.sum())(x))
assert s == 28.0, s
print('4-device CPU mesh + sharded reduce ok')
"""


def run_doctor(backend_timeout: float = 600.0, skip_backend: bool = False,
               log: Callable[[str], None] = print,
               as_json: bool = False) -> int:
    """Run all checks; print one line each (or, with *as_json*, one final
    JSON object); return 0 iff all run checks pass."""
    results: List[Tuple[str, str, str]] = []  # (name, status, detail)

    def record(name: str, status: str, detail: str) -> None:
        results.append((name, status, detail))
        if not as_json:
            tag = {"ok": _OK, "fail": _FAIL, "skip": _SKIP}[status]
            log(f"{tag} {name:8s} {detail}")

    checks: List[Tuple[str, Callable[[], Tuple[bool, str]]]] = [
        ("deps", _check_deps),
        ("native", _check_native),
        ("numerics", _check_numerics),
        ("write", _check_write),
    ]
    for name, fn in checks:
        try:
            ok, detail = fn()
        except Exception as e:  # noqa: BLE001 — a crashed check is a FAIL
            ok, detail = False, f"{type(e).__name__}: {e}"
        record(name, "ok" if ok else "fail", detail)

    if skip_backend:
        record("backend", "skip", "(--skip-backend)")
    else:
        # IP_DOCTOR_BACKEND forces a backend in the probe subprocess
        # (tests use 'cpu'; production leaves it unset for the default)
        ok, detail = _run_sub(
            _backend_code(os.environ.get("IP_DOCTOR_BACKEND", "")),
            timeout=backend_timeout)
        record("backend", "ok" if ok else "fail", detail)

    ok, detail = _run_sub(_MESH_CODE, timeout=max(120.0, backend_timeout))
    record("mesh", "ok" if ok else "fail", detail)

    failures = sum(1 for _, status, _ in results if status == "fail")
    if as_json:
        import json

        log(json.dumps({
            "ok": failures == 0,
            "failures": failures,
            "checks": {n: {"status": s, "detail": d} for n, s, d in results},
        }))
        return 0 if failures == 0 else 1

    log(("all checks passed" if failures == 0
         else f"{failures} check(s) FAILED"))
    return 0 if failures == 0 else 1
