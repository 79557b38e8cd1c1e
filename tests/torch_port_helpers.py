"""Helpers shared by the tests of the PyTorch port (tests/test_torch_port_*.py)."""

import dataclasses


def to_port_config(jcfg):
    """The JAX package's config as the port's own dataclasses."""
    import infinitevl_tpu_torch.config as tconfig

    d = dataclasses.asdict(jcfg)
    return tconfig.InfiniteVLConfig(
        text=tconfig.TextConfig(**d.pop("text")),
        vision=tconfig.VisionConfig(**d.pop("vision")), **d)
