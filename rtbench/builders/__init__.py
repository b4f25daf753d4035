"""Model builders: one file per geometry and grid type, named by a
configuration's `builder` key.

Each builder module has `build(cfg, pkg, polychromatic, refill_batches)`
that turns a configuration file into the objects `OligoSimulation`
takes, from the package `pkg` it is handed (the port, `skirt_tpu_torch`),
which it does not import itself.
"""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def sub(pkg, module: str):
    """`pkg.<module>` of a package handed to a builder."""
    return importlib.import_module(f"{pkg.__name__}.{module}")
