"""The model FLOPs of the window's prompts over the sum of their times to first token, as a share of the bf16 peak."""

from harness.readers import mfu

read = mfu("prefill_flops", "ttft_sum_s")
