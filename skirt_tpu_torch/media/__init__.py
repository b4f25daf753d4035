"""Dust media (twin of skirt_tpu.media; slice 1 subset)."""

from .dust_system import (DustComponent, DustMassNormalization,  # noqa: F401
                          DustSystem, OpticalDepthNormalization)
from .mix import DustMix, SimpleOligoDustMix  # noqa: F401
