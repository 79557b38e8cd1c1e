"""Share of its roofline of kernel A1 in the traced stream steps."""

from harness.readers import roofline

read = roofline("swa_ring")
