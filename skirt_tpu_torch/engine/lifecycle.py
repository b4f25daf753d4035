"""Lifecycle options and dispatch.

Twin of skirt_tpu/engine/lifecycle.py.  `LifecycleOptions` keeps the
reference's field names and defaults so a configuration carries across
unchanged, and adds the port's own (`PORT_OPTIONS`) at defaults that
change nothing; `make_lifecycle` has the fused branches (the polychromatic
analytic engine, slice S1; the monochromatic analytic one, slice S2a; the
monochromatic and polychromatic table engines, slice S4a; polarization on
the fused engines, slice S5a) and names the missing slice for every other
branch.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import rng
from ..media import polarization as pol
from .fused import _hg_costheta


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
    # the port's own (not in skirt_tpu): accepted and ignored by the table
    # engines' exact peel, one kernel launch a pass (make_exact_peel); the
    # agn-torus benchmark configuration still sets it
    peel_graph: bool = False


# LifecycleOptions' fields that skirt_tpu's lacks; a converted
# configuration keeps their defaults
PORT_OPTIONS = ("peel_graph",)


# skirt_tpu's lifecycle.hg_costheta is the event kernels' formula
hg_costheta = _hg_costheta


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


def make_lifecycle_with_fallback(*args, log=None, **kwargs):
    """make_lifecycle, retrying without the fused fast path on ValueError.

    skirt_tpu's retry builds the general (unfused) lifecycle, which is not
    ported yet: here the retry raises, naming slice S2b and the reason the
    fused engine gave, and never runs silently."""
    options = args[4] if len(args) > 4 else kwargs["options"]
    try:
        return make_lifecycle(*args, **kwargs)
    except ValueError as e:
        if not getattr(options, "fused", False):
            raise
        if log is not None:
            log.info(f"fused fast path unavailable ({e}); using the "
                     "general estimators")
        slow = replace(options, fused=False, refill_batches=0,
                       polychromatic=False)
        if len(args) > 4:
            args = args[:4] + (slow,) + args[5:]
        else:
            kwargs["options"] = slow
        try:
            return make_lifecycle(*args, **kwargs)
        except ValueError as e2:
            raise ValueError(f"{e2} [the fused engine refused first: {e}]"
                             ) from e


def make_peel_off(grid, dust_system, instrument, rho_path_map=None):
    """Returns peel(tallies, pos, ell, contribution, tags, tau=...) that
    applies the extinction exp(-tau) toward the instrument and detects.

    Ported: the shared-tau branch (the fused drivers compute tau once per
    observer direction) and the run without dust.  The fast-peeloff map
    (rho_path_map) and the grid-traversal optical depth belong to the
    general lifecycle and raise, naming slice S2b."""
    if rho_path_map is not None:
        raise ValueError("make_peel_off: the fast-peeloff density-path maps "
                         "(compute_rho_path_maps) are not ported yet "
                         "(slice S2b)")
    if hasattr(instrument, "observer_distance"):
        raise ValueError("make_peel_off: perspective instruments are not "
                         "ported yet (slice S6)")

    def peel(tallies, pos, ell, contribution, tags, active=None, cell=None,
             tau=None, kapparho=None):
        if tau is not None:
            extincted = contribution * torch.exp(-tau)
        elif dust_system is None:
            extincted = contribution
        else:
            raise ValueError("make_peel_off: the peel-off optical depth by "
                             "grid traversal is not ported yet (slice S2b)")
        if tags is not None:
            tags = dict(tags, transparent=contribution)
        return instrument.detect(tallies, pos, ell, extincted, tags)

    return peel


def make_lifecycle(grid, dust_system, stellar_system, instruments,
                   options: LifecycleOptions, nlambda: int,
                   launch_fn=None, emission_peeloff: bool = True,
                   scattering_peeloff: bool = True, is_dust_emission=False,
                   mueller=None, io_state: bool = False,
                   max_iterations: int | None = None):
    """Build the per-batch lifecycle run_batch(key, ell, L0, tallies).

    Ported: fused + analytic densities, polychromatic
    (engine/fused_poly.py, kernel K1) or monochromatic (engine/fused.py,
    kernel K3); fused + table densities, polychromatic
    (engine/fused_table_poly.py, kernel K6) or monochromatic
    (engine/fused_table.py, kernel K4).  A Mueller table `mueller` (one
    per dust component, as `DustSystem.mueller` gives them) polarizes the
    monochromatic engines and the polychromatic table engine (K6p); the
    polychromatic analytic engine refuses it, as skirt_tpu's does.  Every
    other branch of skirt_tpu's dispatch raises ValueError naming the
    slice that will port it."""
    ds = dust_system

    def missing(what, slice_):
        raise ValueError(f"make_lifecycle: {what} is not ported yet "
                         f"(slice {slice_}); skirt_tpu_torch runs the "
                         "fused engines only")

    table = getattr(ds, "table", False)
    analytic = getattr(ds, "analytic", False)
    kw = dict(launch_fn=launch_fn, emission_peeloff=emission_peeloff,
              scattering_peeloff=scattering_peeloff,
              is_dust_emission=is_dust_emission, mueller=mueller,
              io_state=io_state, max_iterations=max_iterations)
    if options.fused and options.polychromatic and table:
        from . import fused_table_poly as _ftp
        return _ftp.make_fused_table_poly_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, **kw)
    if options.fused and options.polychromatic and analytic:
        from . import fused_poly as _fp
        return _fp.make_fused_poly_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, **kw)
    if options.fused and table:
        from . import fused_table as _ft
        return _ft.make_fused_table_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, **kw)
    if options.fused:
        from . import fused as _fused
        return _fused.make_fused_lifecycle(
            grid, dust_system, stellar_system, instruments, options,
            nlambda, **kw)
    if mueller is not None and ds is not None:
        # skirt_tpu's check on the vector path (lifecycle.py:453-462)
        if len(pol.mueller_list(mueller)) != ds.ncomp:
            raise ValueError("mueller list must have one entry per dust "
                             "component (None for unpolarized mixes)")
    missing("the general (unfused) vector lifecycle", "S2b")
