"""Lifecycle options and dispatch.

Twin of skirt_tpu/engine/lifecycle.py.  `LifecycleOptions` keeps the
reference's field names and defaults so a configuration carries across
unchanged; `make_lifecycle` has the polychromatic analytic branch only
(slice S1) and names the missing slice for every other branch.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import rng


@dataclass(frozen=True)
class LifecycleOptions:
    """ref: MonteCarloSimulation.hpp property defaults (:41-65); field
    meanings as documented in skirt_tpu.engine.lifecycle."""
    min_weight_reduction: float = 1e4
    min_scatt_events: int = 0
    scatt_bias: float = 0.5
    max_scatt_events: int = 256
    store_absorption: bool = False
    continuous_scattering: bool = False
    fast_peeloff: bool = False
    refill_batches: int = 0
    refill_every: int = 2
    polychromatic: bool = False
    peel_panels: int | None = None
    quadrature_panels: int | None = None
    deposition: str = "path"
    fused: bool = False
    fused_tile_rows: int = 32
    tally_flush: int = 1
    table_peel: str = "exact"
    fused_hw_rng: bool | None = None
    voxelize: bool | None = None
    path_record: bool | None = None
    count_events: bool = False


def make_multibatch(run_batch, nbatches: int, key_fn=None):
    """Run `nbatches` lifecycle batches in one call, re-deriving each
    batch's key with `key_fn(key, b)` (default rng.fold_in) and
    accumulating into the same tallies.

    Returns run_many(key, ell, L0, tallies) -> tallies."""
    kf = key_fn if key_fn is not None else rng.fold_in

    def run_many(key, ell, L0, tallies):
        for b in range(nbatches):
            tallies = run_batch(kf(key, b), ell, L0, tallies)
        return tallies

    return run_many


def make_lifecycle(grid, dust_system, stellar_system, instruments,
                   options: LifecycleOptions, nlambda: int,
                   launch_fn=None, emission_peeloff: bool = True,
                   scattering_peeloff: bool = True, is_dust_emission=False,
                   mueller=None, io_state: bool = False,
                   max_iterations: int | None = None):
    """Build the per-batch lifecycle run_batch(key, ell, L0, tallies).

    Ported: fused + polychromatic + analytic densities
    (engine/fused_poly.py).  Every other branch of skirt_tpu's dispatch
    raises ValueError naming the slice that will port it."""
    ds = dust_system

    def missing(what, slice_):
        raise ValueError(f"make_lifecycle: {what} is not ported yet "
                         f"(slice {slice_}); skirt_tpu_torch runs the "
                         "fused polychromatic analytic path only")

    if ds is None:
        missing("a run without dust", "S2")
    table = getattr(ds, "table", False)
    analytic = getattr(ds, "analytic", False)
    if options.fused and options.polychromatic and table:
        missing("the polychromatic table engine (fused_table_poly)", "S4")
    if options.fused and options.polychromatic and analytic:
        from . import fused_poly as _fp
        return _fp.make_fused_poly_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, launch_fn=launch_fn,
            emission_peeloff=emission_peeloff,
            scattering_peeloff=scattering_peeloff,
            is_dust_emission=is_dust_emission, mueller=mueller,
            io_state=io_state, max_iterations=max_iterations)
    if options.fused and table:
        missing("the monochromatic table engine (fused_table)", "S4")
    if options.fused:
        missing("the monochromatic fused analytic engine (fused)", "S2")
    missing("the unfused vector lifecycle", "S2")
