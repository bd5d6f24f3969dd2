"""imageprocess_tpu — accelerator-native fluorescence-microscopy quantification.

A ground-up JAX/XLA rebuild of the capabilities of gavyek/ImageProcess:
per-ROI intensity quantification, focal-adhesion detection, ratiometric
FRET (incl. nuclear-rim FRET), ROI morphology, channel cropping,
automatic/interactive segmentation and report generation
(CSV/XLSX/PNG/TIFF/PPTX/ImageJ).

Architecture (device-first, not a port):

- ``core``       host-side dataset grammar, TIFF/ROI I/O, configs, logging
- ``geom``       polygon math + on-device polygon rasterization
- ``ops``        jitted numeric core: percentiles, background, masked stats,
                 ratio/QC/spectral math, view pipeline
- ``morphology`` on-device binary morphology, connected components, EDT,
                 contours, region properties
- ``pipelines``  one jit-compiled program per workload, batched over a
                 sharded (stage, time) axis
- ``parallel``   device mesh / sharding / host prefetch
- ``report``     CSV/XLSX/PNG/TIFF/PPTX writers (host side)
"""

import os

__version__ = "0.1.0"


#: compile-cache directory used when JAX_COMPILATION_CACHE_DIR is unset:
#: fixed, inside the checkout (the path is part of the cache key, and a
#: per-user directory would be shared by machines of different kinds)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (first compile of the
    pipeline programs costs seconds; later CLI invocations then start
    hot).  JAX reads JAX_COMPILATION_CACHE_DIR itself when it is set;
    otherwise the cache goes to :data:`DEFAULT_CACHE_DIR`.  Opt out with
    IMAGEPROCESS_TPU_NO_CACHE=1."""
    if os.environ.get("IMAGEPROCESS_TPU_NO_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_compilation_cache()
