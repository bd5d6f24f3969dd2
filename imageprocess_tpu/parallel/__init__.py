"""Device-mesh parallelism: batch execution of the workload
pipelines (the device equivalent of the reference's ProcessPoolExecutor fan-out
over (stage, time) keys, SURVEY §2.3)."""

from .runner import (  # noqa: F401
    make_mesh,
    batched_intensity_step,
    batched_intensity_step_tiled,
    per_device,
    PrefetchLoader,
)
from . import spatial  # noqa: F401
