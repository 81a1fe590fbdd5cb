"""Host-to-device copies a frame on the oversized path in the window
(`upload.calls`, the program's counter, over the window's frames): each
layer's seven tables and three bins."""

from .uploads_per_frame import read  # noqa: F401  (the same count)
