"""Share of its roofline of kernel C in the traced requests' prefills."""

from harness.readers import roofline

read = roofline("delta_chunk")
