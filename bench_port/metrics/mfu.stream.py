"""The model FLOPs of the frames the window ingested over the window's time, as a share of the bf16 peak."""

from harness.readers import mfu

read = mfu("flops", "wall_s")
