"""An ExpDisk stellar disc in an ExpDisk dust disc on a Cartesian grid
with analytic densities, read from a configuration file: the structure
of `bench_torch.py::_model`, with the configuration's optics (a power
law in kappa, albedo and g linear in wavelength) and its face-on optical
depth at a reference wavelength."""

import time

import numpy as np

from . import sub


def wavelengths(cfg):
    wl = cfg["wavelengths"]
    return np.linspace(wl["min_m"], wl["max_m"], wl["count"])


def optics(cfg):
    """(kappa_ext, albedo, g), each per wavelength, from the
    configuration's laws."""
    lam = wavelengths(cfg)
    o = cfg["dust"]["optics"]
    f = (lam - lam[0]) / (lam[-1] - lam[0])
    kappa = o["kappa_ext_m2_per_kg_first"] * (lam / lam[0]) ** o["kappa_slope"]
    a0, a1 = o["albedo"]
    g0, g1 = o["asymmetry_g"]
    return kappa, a0 + (a1 - a0) * f, g0 + (g1 - g0) * f


def build(cfg, pkg, polychromatic: bool, refill_batches: int):
    """(model, host seconds): model holds the grid, dust system, stellar
    system, instruments and lifecycle options; the host seconds are those
    of building the grid and the dust system."""
    KPC = sub(pkg, "constants").KPC
    geo = sub(pkg, "geometry")
    media = sub(pkg, "media")
    n = cfg["wavelengths"]["count"]
    wg = sub(pkg, "wavelengths").OligoWavelengthGrid(list(wavelengths(cfg)))
    st = cfg["stars"]
    src = sub(pkg, "sources")
    ss = src.StellarSystem([src.LuminosityStellarComponent(
        geo.ExpDiskGeometry(st["scale_length_kpc"] * KPC,
                            st["scale_height_kpc"] * KPC),
        wg, [cfg["luminosity_W"]] * n)])
    t0 = time.perf_counter()
    g = cfg["grid"]
    b = np.linspace(-g["half_xy_kpc"] * KPC, g["half_xy_kpc"] * KPC,
                    g["nx"] + 1)
    bz = np.linspace(-g["half_z_kpc"] * KPC, g["half_z_kpc"] * KPC,
                     g["nz"] + 1)
    grid = sub(pkg, "grids").CartesianGrid(b, b, bz)
    d = cfg["dust"]
    kappa, albedo, g_ = optics(cfg)
    mix = media.SimpleOligoDustMix(wg, list(kappa), list(albedo), list(g_))
    comp = media.DustComponent(
        geo.ExpDiskGeometry(d["scale_length_kpc"] * KPC,
                            d["scale_height_kpc"] * KPC), mix,
        media.OpticalDepthNormalization("z", d["tau_wavelength_m"],
                                        d["tau_z_face_on"]))
    dsys = media.DustSystem(grid, [comp],
                            samples_per_cell=g["samples_per_cell"],
                            density_mode=g["density_mode"])
    host_s = time.perf_counter() - t0
    ins = sub(pkg, "instruments")
    instruments = []
    for i in cfg["instruments"]:
        if i["kind"] == "sed":
            instruments.append(ins.SEDInstrument(
                i["name"], i["distance_m"], n, inclination=i["inclination"]))
        else:
            instruments.append(ins.SimpleInstrument(
                i["name"], i["distance_m"], n, i["nx"], i["ny"],
                fov_x=i["fov_kpc"] * KPC, fov_y=i["fov_kpc"] * KPC,
                inclination=i["inclination"]))
    e = cfg["engine"]
    opts = sub(pkg, "engine.lifecycle").LifecycleOptions(
        store_absorption=e["store_absorption"],
        min_weight_reduction=e["min_weight_reduction"],
        max_scatt_events=e["max_scatt_events"], deposition=e["deposition"],
        quadrature_panels=e["quadrature_panels"],
        refill_batches=refill_batches, peel_panels=e["peel_panels"],
        fused=True, polychromatic=polychromatic, voxelize=e["voxelize"])
    return dict(grid=grid, dust_system=dsys, stellar_system=ss,
                instruments=instruments, options=opts), host_s
