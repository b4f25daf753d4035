"""Physical constants (SI) of the port's run path.

Twin of skirt_tpu/constants.py (slice 1: the lengths the models use).
The values are skirt_tpu's, digit for digit; the port keeps its own copy
so that a run imports no module of skirt_tpu.
"""

PC = 3.08567758e16      # m, parsec
KPC = 1e3 * PC
