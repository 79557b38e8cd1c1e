"""Share of its roofline of kernel C in the traced stream steps."""

from harness.readers import roofline

read = roofline("delta_chunk")
