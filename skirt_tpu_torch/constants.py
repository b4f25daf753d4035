"""Physical constants (SI) of the port's run path and its writers.

Twin of skirt_tpu/constants.py: the lengths the models use and the
constants of the output unit system (`units.py`), and the electron's
(`ElectronDustMix`).  The values are
skirt_tpu's, digit for digit; the port keeps its own copy so that it
imports no module of skirt_tpu.
"""

# speed of light [m/s]
C_LIGHT = 2.99792458e8
# Boltzmann constant [J/K]
K_BOLTZMANN = 1.3806488e-23
# electron mass [kg]
M_ELECTRON = 9.10938215e-31
# Thomson cross section [m^2]
SIGMA_THOMSON = 6.652458734e-29

# astronomical unit [m]
AU = 1.49597871e11
PC = 3.08567758e16      # m, parsec
KPC = 1e3 * PC
MPC = 1e6 * PC
# solar luminosity [W]
L_SUN = 3.839e26
# solar mass [kg]
M_SUN = 1.9891e30
# light year [m]
LY = 9.460730472e15

MICRON = 1e-6
ANGSTROM = 1e-10
NANOMETER = 1e-9

# arcsec in radians
ARCSEC = 4.84813681109536e-6
ARCSEC2 = ARCSEC * ARCSEC

# Jansky [W/m^2/Hz]
JANSKY = 1e-26
