"""The share of the traced stream steps in which no operation ran on the card."""

from harness.readers import device_idle_pct

read = device_idle_pct()
