"""Segmentation: interactive in-polygon refinement (the drawer's core) and
batch automatic full-frame segmentation (the device ROI_auto path, with
an optional Cellpose escape hatch)."""

from .autoseg import segment_inside_polygon  # noqa: F401
from .auto import AutoSegConfig, auto_segment_frame, run_auto_drawer  # noqa: F401
