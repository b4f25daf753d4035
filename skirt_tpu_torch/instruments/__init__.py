"""Instruments (twin of skirt_tpu.instruments; the distant instruments)."""

from .instruments import (DistantInstrument, FrameInstrument,  # noqa: F401
                          FullInstrument, SEDInstrument, SimpleInstrument)
