"""PNG panel options, kept apart from the matplotlib renderers so the
tables-only paths never import matplotlib."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _auto_minmax_np(vals: np.ndarray, p_lo: float, p_hi: float):
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return 0.0, 1.0
    lo = float(np.percentile(vals, p_lo))
    hi = float(np.percentile(vals, p_hi))
    if hi <= lo:
        hi = lo + 1e-6
    return lo, hi


@dataclass
class PanelPngOptions:
    """One PNG output panel (the reference's full_* / crop_* GUI group)."""

    enabled: bool = True
    cmap_on: bool = False
    cmap: str = "jet"
    cmin: str = ""      # "" = auto from percentiles
    cmax: str = ""
    mask_outside: bool = False
    colorbar: bool = False
    scalebar_um: Optional[float] = None
    sb_anchor: str = "br"
    sb_font: int = 10
    dpi: int = 300

    def vminmax(self, vals: np.ndarray, auto_lo: float, auto_hi: float):
        """get_vminmax semantics (Fluor_INT.py:956-966): explicit bounds win;
        bad/missing bounds fall back to percentile auto-range; no colormap
        mode -> autoscale imshow (None, None)."""
        if not self.cmap_on:
            return None, None
        vmin = float(self.cmin) if self.cmin != "" else None
        vmax = float(self.cmax) if self.cmax != "" else None
        if vmin is None or vmax is None or vmax <= vmin:
            lo, hi = _auto_minmax_np(vals, auto_lo, auto_hi)
            vmin = lo if vmin is None else vmin
            if vmax is None or vmax <= vmin:
                vmax = hi
        return vmin, vmax
