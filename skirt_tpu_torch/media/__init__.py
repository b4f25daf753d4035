"""Dust media (twin of skirt_tpu.media; the ported subset)."""

from .dust_system import (DustComponent, DustMassNormalization,  # noqa: F401
                          DustSystem, OpticalDepthNormalization)
from .mix import (DustMix, ElectronDustMix,  # noqa: F401
                  SimpleOligoDustMix)
