"""On-device binary morphology, connected components, distance transforms,
region properties — the device replacement for the reference's
scipy.ndimage / skimage.morphology / skimage.measure calls (SURVEY §2.2,
"native-equivalent tier")."""

from .binary import (  # noqa: F401
    disk,
    binary_dilation,
    binary_erosion,
    binary_closing_skimage,
    square_dilation,
    annulus_mask,
)
from .ccl import label, remove_small_objects, fill_holes, largest_component  # noqa: F401
from .edt import clamped_sq_edt, rim_mask  # noqa: F401
from .regions import region_props  # noqa: F401
from .contours import find_contours, polygon_area_contour  # noqa: F401
