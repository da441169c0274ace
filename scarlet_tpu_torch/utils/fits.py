"""Minimal FITS image reader (primary HDU), self-contained: the port's
copy of scarlet_tpu/utils/fits.py.

astropy is optional in the runtime; this reads simple image FITS files
(2880-byte header blocks of 80-char cards, big-endian data) and extracts
the WCS keywords into a :class:`~scarlet_tpu_torch.utils.wcs.AffineWCS`.
Host numpy only: it needs no device.
"""
from __future__ import annotations

import numpy as np

from .wcs import AffineWCS

__all__ = ["read_fits", "read_pickled_wcs"]

_BITPIX_DTYPE = {
    8: np.uint8,
    16: ">i2",
    32: ">i4",
    64: ">i8",
    -32: ">f4",
    -64: ">f8",
}


def _parse_card(card):
    key = card[:8].strip()
    if "=" not in card or not key or key in ("COMMENT", "HISTORY"):
        return key, None
    value = card[10:].split("/")[0].strip()
    if value.startswith("'"):
        return key, value.strip("'").strip()
    if value in ("T", "F"):
        return key, value == "T"
    try:
        if any(c in value for c in ".eED") and not value.lstrip("+-").isdigit():
            return key, float(value.replace("D", "E"))
        return key, int(value)
    except ValueError:
        return key, value


def _wcs_from_header(header, array_shape=None):
    """Build an AffineWCS from a FITS header card dict (or None)."""
    if "CRPIX1" not in header:
        return None
    crpix = np.array([header["CRPIX1"], header["CRPIX2"]], float)
    crval = np.array([header.get("CRVAL1", 0.0),
                      header.get("CRVAL2", 0.0)], float)
    if "CD1_1" in header:
        pc = np.array([
            [header["CD1_1"], header.get("CD1_2", 0.0)],
            [header.get("CD2_1", 0.0), header["CD2_2"]],
        ])
        cdelt = np.ones(2)
    else:
        cdelt = np.array([header.get("CDELT1", 1.0),
                          header.get("CDELT2", 1.0)])
        pc = np.array([
            [header.get("PC1_1", 1.0), header.get("PC1_2", 0.0)],
            [header.get("PC2_1", 0.0), header.get("PC2_2", 1.0)],
        ])
    ctype = (header.get("CTYPE1", "RA---TAN"),
             header.get("CTYPE2", "DEC--TAN"))
    return AffineWCS(crpix=crpix, crval=crval, pc=pc, cdelt=cdelt,
                     ctype=ctype, array_shape=array_shape)


def _header_from_bytes(raw):
    """Parse FITS header cards from a bytes blob into a dict."""
    text = raw.decode("ascii", errors="replace")
    header = {}
    for i in range(0, len(text), 80):
        card = text[i:i + 80]
        if card.startswith("END"):
            break
        key, val = _parse_card(card)
        if val is not None:
            header[key] = val
    return header


def read_pickled_wcs(npz_path, key="wcs"):
    """Extract astropy-pickled WCS entries from an npz WITHOUT astropy.

    astropy serializes ``astropy.wcs.WCS`` as
    ``__WCS_unpickle__(WCS, state_dict, fits_header_bytes)``; a stub
    unpickler intercepts that call, parses the embedded FITS header with
    this module's card parser, and returns :class:`AffineWCS` objects
    (array_shape restored from the pickled ``_naxis``).  Used to load the
    reference's multi-resolution acceptance data
    (reference tests/test_multiresolution.py:52-62) in an astropy-free
    runtime.  Returns a list of AffineWCS (or None for non-WCS entries).
    """
    import io
    import pickle
    import zipfile
    from numpy.lib import format as _npformat

    class _StubWCS:
        def __init__(self, *a, **k):
            pass

    def _unpickle_wcs(cls, dct, fits_bytes):
        header = _header_from_bytes(fits_bytes)
        naxis = dct.get("_naxis") if isinstance(dct, dict) else None
        # _naxis is (nx, ny); array_shape follows numpy (ny, nx)
        array_shape = tuple(int(n) for n in naxis[::-1]) if naxis else None
        return _wcs_from_header(header, array_shape=array_shape)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("astropy"):
                if name == "__WCS_unpickle__":
                    return _unpickle_wcs
                return _StubWCS
            return super().find_class(module, name)

    with zipfile.ZipFile(npz_path) as z:
        f = io.BytesIO(z.read(key + ".npy"))
        version = _npformat.read_magic(f)
        _npformat._read_array_header(f, version)
        arr = _Unpickler(f).load()
    return list(arr)


def read_fits(path, hdu=0):
    """Read an image HDU: returns (data, header dict, wcs or None)."""
    with open(path, "rb") as f:
        raw = f.read()

    offset = 0
    for h in range(hdu + 1):
        header = {}
        end = False
        while not end:
            block = raw[offset:offset + 2880].decode("ascii", errors="replace")
            offset += 2880
            for i in range(0, 2880, 80):
                card = block[i:i + 80]
                if card.startswith("END"):
                    end = True
                    break
                key, val = _parse_card(card)
                if val is not None:
                    header[key] = val

        naxis = header.get("NAXIS", 0)
        shape = tuple(
            int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1)
        )
        bitpix = header.get("BITPIX", -32)
        nbytes = int(np.prod(shape)) * abs(bitpix) // 8 if shape else 0
        if h == hdu:
            data = np.frombuffer(
                raw[offset:offset + nbytes], dtype=_BITPIX_DTYPE[bitpix]
            ).reshape(shape).astype(np.float64)
            bscale = header.get("BSCALE", 1.0)
            bzero = header.get("BZERO", 0.0)
            if bscale != 1.0 or bzero != 0.0:
                data = data * bscale + bzero
            break
        # skip data (padded to 2880)
        offset += (nbytes + 2879) // 2880 * 2880

    wcs = _wcs_from_header(header, array_shape=shape[-2:] if shape else None)
    return data, header, wcs
