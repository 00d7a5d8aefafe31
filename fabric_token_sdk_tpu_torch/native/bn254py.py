"""ctypes binding for the native BN254 host library (bn254.c).

Batched G1 scalar multiplication / multiexp / sum on the host control
plane. Mirrors the group-op API of `crypto.hostmath`; `hostmath` installs
these as its fast path at import when the library builds. Points are affine int tuples or None (infinity),
scalars plain ints; conversion to 4x64 little-endian limb buffers happens
here.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_bn254.so")
_SRC = os.path.join(_HERE, "bn254.c")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                # build to a private temp path, os.rename into place:
                # atomic on POSIX, so concurrent builders never load a
                # half-written ELF
                tmp = f"{_SO}.{os.getpid()}.tmp"
                built = False
                for cc in ("cc", "gcc", "clang"):
                    try:
                        subprocess.run(
                            [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                            check=True, capture_output=True, timeout=180,
                        )
                        os.rename(tmp, _SO)
                        built = True
                        break
                    except Exception:
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
                        continue
                if not built:
                    return None
            lib = ctypes.CDLL(_SO)
            for name in ("fts_g1_mul_batch", "fts_g1_multiexp", "fts_g1_sum",
                         "fts_g1_multiexp_rows"):
                getattr(lib, name).restype = None
            lib.fts_g1_mul_batch.argtypes = [
                _U64P, _U64P, _U8P, _U64P, ctypes.c_long, _U64P, _U64P, _U8P]
            lib.fts_g1_multiexp.argtypes = [
                _U64P, _U64P, _U8P, _U64P, ctypes.c_long, _U64P, _U64P, _U8P]
            lib.fts_g1_sum.argtypes = [
                _U64P, _U64P, _U8P, ctypes.c_long, _U64P, _U64P, _U8P]
            lib.fts_g1_multiexp_rows.argtypes = [
                _U64P, _U64P, _U8P, _U64P, ctypes.c_long, ctypes.c_long,
                _U64P, _U64P, _U8P]
            for name in ("fts_g2_mul_batch", "fts_g2_multiexp", "fts_g2_sum",
                         "fts_pairing_product"):
                getattr(lib, name).restype = None
            lib.fts_g2_mul_batch.argtypes = [
                _U64P, _U8P, _U64P, ctypes.c_long, _U64P, _U8P]
            lib.fts_g2_multiexp.argtypes = [
                _U64P, _U8P, _U64P, ctypes.c_long, _U64P, _U8P]
            lib.fts_g2_sum.argtypes = [_U64P, _U8P, ctypes.c_long, _U64P, _U8P]
            lib.fts_pairing_product.argtypes = [
                _U64P, _U64P, _U8P, _U64P, _U8P, ctypes.c_long, _U64P, _U8P]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _pack_points(points: Sequence):
    n = len(points)
    xs = (ctypes.c_uint64 * (4 * n))()
    ys = (ctypes.c_uint64 * (4 * n))()
    inf = (ctypes.c_uint8 * n)()
    for i, pt in enumerate(points):
        if pt is None:
            inf[i] = 1
            continue
        x, y = pt
        for j in range(4):
            xs[4 * i + j] = (x >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
            ys[4 * i + j] = (y >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return xs, ys, inf


def _pack_scalars(scalars: Sequence[int]):
    n = len(scalars)
    ks = (ctypes.c_uint64 * (4 * n))()
    for i, k in enumerate(scalars):
        k %= _R
        for j in range(4):
            ks[4 * i + j] = (k >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return ks


def _unpack_points(ox, oy, oinf, n: int) -> List:
    out = []
    for i in range(n):
        if oinf[i]:
            out.append(None)
            continue
        x = y = 0
        for j in range(3, -1, -1):
            x = (x << 64) | ox[4 * i + j]
            y = (y << 64) | oy[4 * i + j]
        out.append((x, y))
    return out


def g1_mul_batch(points: Sequence, scalars: Sequence[int]) -> List:
    """[k_i * P_i] for parallel lists of points/scalars."""
    lib = _load()
    n = len(points)
    if len(scalars) != n:
        raise ValueError(f"mul_batch length mismatch: {n} != {len(scalars)}")
    if n == 0:
        return []
    xs, ys, inf = _pack_points(points)
    ks = _pack_scalars(scalars)
    ox = (ctypes.c_uint64 * (4 * n))()
    oy = (ctypes.c_uint64 * (4 * n))()
    oinf = (ctypes.c_uint8 * n)()
    lib.fts_g1_mul_batch(xs, ys, inf, ks, n, ox, oy, oinf)
    return _unpack_points(ox, oy, oinf, n)


def g1_mul(pt, k: int):
    return g1_mul_batch([pt], [k])[0]


def g1_multiexp(points: Sequence, scalars: Sequence[int]):
    lib = _load()
    n = len(points)
    if len(scalars) != n:
        raise ValueError(f"multiexp length mismatch: {n} != {len(scalars)}")
    if n == 0:
        return None
    xs, ys, inf = _pack_points(points)
    ks = _pack_scalars(scalars)
    ox = (ctypes.c_uint64 * 4)()
    oy = (ctypes.c_uint64 * 4)()
    oinf = (ctypes.c_uint8 * 1)()
    lib.fts_g1_multiexp(xs, ys, inf, ks, n, ox, oy, oinf)
    return _unpack_points(ox, oy, oinf, 1)[0]


def g1_sum(points: Sequence):
    lib = _load()
    n = len(points)
    if n == 0:
        return None
    xs, ys, inf = _pack_points(points)
    ox = (ctypes.c_uint64 * 4)()
    oy = (ctypes.c_uint64 * 4)()
    oinf = (ctypes.c_uint8 * 1)()
    lib.fts_g1_sum(xs, ys, inf, n, ox, oy, oinf)
    return _unpack_points(ox, oy, oinf, 1)[0]


def _pack_g2(points: Sequence):
    """G2 affine ((x0,x1),(y0,y1)) tuples / None -> 16 u64 limbs each."""
    n = len(points)
    coords = (ctypes.c_uint64 * (16 * n))()
    inf = (ctypes.c_uint8 * n)()
    for i, pt in enumerate(points):
        if pt is None:
            inf[i] = 1
            continue
        (x0, x1), (y0, y1) = pt
        for k, v in enumerate((x0, x1, y0, y1)):
            for j in range(4):
                coords[16 * i + 4 * k + j] = (v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return coords, inf


def _unpack_g2(out, oinf, n: int) -> List:
    res = []
    for i in range(n):
        if oinf[i]:
            res.append(None)
            continue
        vals = []
        for k in range(4):
            v = 0
            for j in range(3, -1, -1):
                v = (v << 64) | out[16 * i + 4 * k + j]
            vals.append(v)
        res.append(((vals[0], vals[1]), (vals[2], vals[3])))
    return res


def g2_mul_batch(points: Sequence, scalars: Sequence[int]) -> List:
    lib = _load()
    n = len(points)
    if len(scalars) != n:
        raise ValueError(f"g2 mul_batch length mismatch: {n} != {len(scalars)}")
    if n == 0:
        return []
    coords, inf = _pack_g2(points)
    ks = _pack_scalars(scalars)
    out = (ctypes.c_uint64 * (16 * n))()
    oinf = (ctypes.c_uint8 * n)()
    lib.fts_g2_mul_batch(coords, inf, ks, n, out, oinf)
    return _unpack_g2(out, oinf, n)


def g2_mul(pt, k: int):
    return g2_mul_batch([pt], [k])[0]


def g2_multiexp(points: Sequence, scalars: Sequence[int]):
    lib = _load()
    n = len(points)
    if len(scalars) != n:
        raise ValueError(f"g2 multiexp length mismatch: {n} != {len(scalars)}")
    if n == 0:
        return None
    coords, inf = _pack_g2(points)
    ks = _pack_scalars(scalars)
    out = (ctypes.c_uint64 * 16)()
    oinf = (ctypes.c_uint8 * 1)()
    lib.fts_g2_multiexp(coords, inf, ks, n, out, oinf)
    return _unpack_g2(out, oinf, 1)[0]


def g2_sum(points: Sequence):
    lib = _load()
    n = len(points)
    if n == 0:
        return None
    coords, inf = _pack_g2(points)
    out = (ctypes.c_uint64 * 16)()
    oinf = (ctypes.c_uint8 * 1)()
    lib.fts_g2_sum(coords, inf, n, out, oinf)
    return _unpack_g2(out, oinf, 1)[0]


def pairing_product(pairs: Sequence):
    """prod e(P_i, Q_i) with one shared final exponentiation.

    Returns the GT element as a 6-tuple of (a, b) int pairs in the flat
    w-basis — the same representation as `hostmath`'s Fp12.
    """
    lib = _load()
    g1s = [p for p, _ in pairs]
    g2s = [q for _, q in pairs]
    n = len(pairs)
    if n == 0:
        n = 1
        g1s, g2s = [None], [None]
    xs, ys, inf1 = _pack_points(g1s)
    coords, inf2 = _pack_g2(g2s)
    out = (ctypes.c_uint64 * 48)()
    is_one = (ctypes.c_uint8 * 1)()
    lib.fts_pairing_product(xs, ys, inf1, coords, inf2, n, out, is_one)
    gt = []
    for j in range(6):
        a = b = 0
        for k in range(3, -1, -1):
            a = (a << 64) | out[8 * j + k]
            b = (b << 64) | out[8 * j + 4 + k]
        gt.append((a, b))
    return tuple(gt)


def pairing(p, q):
    return pairing_product([(p, q)])


def g1_multiexp_rows(points_rows: Sequence[Sequence],
                     scalar_rows: Sequence[Sequence[int]]) -> List:
    """One multiexp per row; all rows must share the same width."""
    lib = _load()
    rows = len(points_rows)
    if rows == 0:
        return []
    m = len(points_rows[0])
    flat_pts, flat_ks = [], []
    for pr, sr in zip(points_rows, scalar_rows):
        if len(pr) != m or len(sr) != m:
            raise ValueError("multiexp_rows: ragged rows")
        flat_pts.extend(pr)
        flat_ks.extend(sr)
    xs, ys, inf = _pack_points(flat_pts)
    ks = _pack_scalars(flat_ks)
    ox = (ctypes.c_uint64 * (4 * rows))()
    oy = (ctypes.c_uint64 * (4 * rows))()
    oinf = (ctypes.c_uint8 * rows)()
    lib.fts_g1_multiexp_rows(xs, ys, inf, ks, rows, m, ox, oy, oinf)
    return _unpack_points(ox, oy, oinf, rows)
