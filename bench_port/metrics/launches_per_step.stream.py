"""Kernel launches per lockstep stream step in the traced stretch."""

from harness.readers import launches_per_step

read = launches_per_step()
