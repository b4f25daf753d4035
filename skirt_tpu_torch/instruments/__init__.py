"""Instruments (twin of skirt_tpu.instruments; slice 1 subset)."""

from .instruments import (DistantInstrument, FrameInstrument,  # noqa: F401
                          SEDInstrument, SimpleInstrument)
