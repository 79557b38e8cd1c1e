"""Share of their roofline of the ViT's flash kernels (E, F) in the traced stream steps."""

from harness.readers import roofline

read = roofline("vit_flash")
