"""A point source inside a smooth dusty torus (SKIRT's TorusGeometry) on
an octree, read from a configuration file: the structure of
`bench_torch.py::_octree_model`, with the configuration's geometry,
optics (kappa a power law through its end values, albedo and g linear in
log lambda), optical depth and instruments.  The octree's gridded dust
system goes to `OligoSimulation` with voxelize="table", which traces it
through its exact uniform voxel view on the table engines, the exact peel
replayed as one CUDA graph a pass (`peel_graph`)."""

import time

import numpy as np

from . import sub


def wavelengths(cfg):
    wl = cfg["wavelengths"]
    return np.geomspace(wl["min_m"], wl["max_m"], wl["count"])


def optics(cfg):
    """(kappa_ext, albedo, g), each per wavelength, from the
    configuration's laws."""
    lam = wavelengths(cfg)
    o = cfg["dust"]["optics"]
    f = np.log(lam / lam[0]) / np.log(lam[-1] / lam[0])
    kappa = o["kappa_ext_m2_per_kg_first"] * o["kappa_ratio_last_first"] ** f
    a0, a1 = o["albedo"]
    g0, g1 = o["asymmetry_g"]
    return kappa, a0 + (a1 - a0) * f, g0 + (g1 - g0) * f


def build(cfg, pkg, polychromatic: bool, refill_batches: int):
    """(model, host seconds): model holds the octree, its gridded dust
    system, the stellar system, the instruments and the lifecycle
    options; the host seconds are those of building the octree and
    gridding the dust onto its leaves."""
    PC = sub(pkg, "constants").PC
    geo = sub(pkg, "geometry")
    media = sub(pkg, "media")
    n = cfg["wavelengths"]["count"]
    wg = sub(pkg, "wavelengths").OligoWavelengthGrid(list(wavelengths(cfg)))
    src = sub(pkg, "sources")
    ss = src.StellarSystem([src.LuminosityStellarComponent(
        geo.PointGeometry(), wg, [cfg["luminosity_W"]] * n)])
    d = cfg["dust"]
    torus = geo.TorusGeometry(d["p"], d["q"], d["delta_rad"],
                              d["r_in_pc"] * PC, d["r_out_pc"] * PC)
    t0 = time.perf_counter()
    g = cfg["grid"]
    half = g["half_pc"] * PC
    grid = sub(pkg, "grids").OctreeGrid(
        (-half, -half, -half, half, half, half), torus.density,
        min_level=g["min_level"], max_level=g["max_level"],
        max_mass_fraction=g["max_mass_fraction"],
        samples_per_node=g["samples_per_node"], seed=g["tree_seed"],
        subdivision=g["subdivision"])
    kappa, albedo, g_ = optics(cfg)
    mix = media.SimpleOligoDustMix(wg, list(kappa), list(albedo), list(g_))
    comp = media.DustComponent(torus, mix, media.OpticalDepthNormalization(
        d["tau_axis"], d["tau_wavelength_m"], d["tau_v"]))
    dsys = media.DustSystem(grid, [comp],
                            samples_per_cell=g["samples_per_cell"])
    host_s = time.perf_counter() - t0
    ins = sub(pkg, "instruments")
    instruments = [ins.SEDInstrument(i["name"], i["distance_m"], n,
                                     inclination=i["inclination"])
                   for i in cfg["instruments"]]
    e = cfg["engine"]
    opts = sub(pkg, "engine.lifecycle").LifecycleOptions(
        store_absorption=e["store_absorption"],
        min_weight_reduction=e["min_weight_reduction"],
        max_scatt_events=e["max_scatt_events"], deposition=e["deposition"],
        quadrature_panels=e["quadrature_panels"],
        refill_batches=refill_batches, peel_panels=e["peel_panels"],
        table_peel=e["table_peel"], fused=True, polychromatic=polychromatic,
        voxelize=e["voxelize"], peel_graph=e["peel_graph"])
    return dict(grid=grid, dust_system=dsys, stellar_system=ss,
                instruments=instruments, options=opts), host_s
