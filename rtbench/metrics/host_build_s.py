"""Seconds on the host clock of building the grid, the dust system and
the simulation (its lifecycle) before the warm-up run().  Layer: the
host build; it moves setup_s."""


def read(trace):
    return trace.host_build_s
