"""FITS image writer (no astropy dependency) of the port's instruments.

Copy of the writer in skirt_tpu/io/fits.py (the port imports no module of
skirt_tpu): 2-D frames and 3-D spectral cubes with the keywords the
reference emits (ref: SKIRTcore/FITSInOut.cpp:32,95 and
SKIRTcore/Image.cpp:174,277-301).  skirt_tpu.io.fits.read_fits reads them.
"""

from __future__ import annotations

import numpy as np

_BLOCK = 2880
_CARD = 80


def _card(key: str, value, comment: str = "") -> bytes:
    if value is None:
        text = f"{key:<8}"
    elif isinstance(value, bool):
        text = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, int):
        text = f"{key:<8}= {value:>20}"
    elif isinstance(value, float):
        text = f"{key:<8}= {value:>20.14E}"
    else:
        text = f"{key:<8}= '{str(value):<8}'"
    if comment:
        text += f" / {comment}"
    return text[:_CARD].ljust(_CARD).encode("ascii")


def write_fits(path: str, data: np.ndarray, *,
               incx: float = 1.0, incy: float = 1.0,
               xc: float = 0.0, yc: float = 0.0,
               units: str = "", extra_cards: dict | None = None) -> None:
    """Write a 2-D image (ny,nx) or 3-D cube (nframes,ny,nx) as float64 FITS.

    Matches the reference's axis order and keywords (ref: SKIRTcore/FITSInOut.cpp
    Write: CRPIX at center, CRVAL xc/yc, CDELT incx/incy).
    """
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 2:
        naxis = [data.shape[1], data.shape[0]]
    elif data.ndim == 3:
        naxis = [data.shape[2], data.shape[1], data.shape[0]]
    else:
        raise ValueError("FITS writer supports 2-D or 3-D arrays")

    cards = [
        _card("SIMPLE", True, "conforms to FITS standard"),
        _card("BITPIX", -64),
        _card("NAXIS", len(naxis)),
    ]
    for i, n in enumerate(naxis):
        cards.append(_card(f"NAXIS{i+1}", int(n)))
    cards += [
        _card("CRPIX1", (naxis[0] + 1) / 2.0, "X of reference pixel"),
        _card("CRVAL1", float(xc), "coordinate at X reference pixel"),
        _card("CDELT1", float(incx), "coordinate increment along X"),
        _card("CRPIX2", (naxis[1] + 1) / 2.0, "Y of reference pixel"),
        _card("CRVAL2", float(yc), "coordinate at Y reference pixel"),
        _card("CDELT2", float(incy), "coordinate increment along Y"),
    ]
    if units:
        cards.append(_card("BUNIT", units, "physical unit of array values"))
    for key, val in (extra_cards or {}).items():
        cards.append(_card(key, val))
    cards.append(b"END".ljust(_CARD))

    header = b"".join(cards)
    header += b" " * (-len(header) % _BLOCK)

    payload = data.astype(">f8").tobytes()
    payload += b"\0" * (-len(payload) % _BLOCK)

    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)
