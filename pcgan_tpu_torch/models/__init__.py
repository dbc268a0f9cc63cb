"""Networks of the port."""

from pcgan_tpu_torch.models.registry import define_D, define_G  # noqa: F401
