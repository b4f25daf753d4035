"""Sources (twin of skirt_tpu.sources; slice 1 subset)."""

from .stellar import LuminosityStellarComponent, StellarSystem  # noqa: F401
