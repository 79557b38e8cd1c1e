"""Host milliseconds a stream step waits for native.FramePipeline's frames (mean over the window's steps)."""

from harness.readers import window_mean

read = window_mean("prep_wait_ms")
