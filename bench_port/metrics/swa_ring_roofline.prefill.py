"""Share of its roofline of kernel A1 in the traced requests' prefills."""

from harness.readers import roofline

read = roofline("swa_ring")
