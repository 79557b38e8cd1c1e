"""Ops of the torch port: plain torch versions and the Hopper kernel wrappers."""
