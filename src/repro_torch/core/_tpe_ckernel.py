"""Compiled squared-distance sums for the TPE's Parzen densities.

``TPE._log_kde`` scores n candidates against m Parzen components over D
dims; its inner work is ``s[i, j] = sum_d ((x[i, d] - p[j, d]) / bw[j, d])**2``.
In numpy that builds and reduces three (n, m, D) temporaries per call, on a
strided broadcast loop; this module computes the same (n, m) array in one
pass of C, called through ``ctypes``.

Float contract — why the sums are numpy's bit for bit:

  * the difference, the quotient and the square are single correctly
    rounded IEEE operations in both, as long as nothing fuses them: the
    source is compiled with ``-ffp-contract=off`` and without
    ``-ffast-math`` (GCC would otherwise contract ``s += t * t`` into an
    FMA, one rounding where numpy makes two);
  * ``np.sum(..., axis=-1)`` over a contiguous last axis runs numpy's
    ``pairwise_sum``, and ``sq_sum`` below is that function's order: under
    8 terms a plain left-to-right loop; up to 128 terms eight accumulators
    combined as ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, then the tail in
    order; above 128 a split at ``n/2`` rounded down to a multiple of 8,
    each half summed the same way. The reduction adds the sum to an
    output of 0.0, which leaves a non-negative sum as it is.

Built on first use through ``_dse_ckernel.compile_shared`` (same build
directory, hash-keyed ``.so``). No compiler or a failed build: ``get_lib()``
returns None and ``TPE._log_kde`` runs the numpy expression.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from repro_torch.core._dse_ckernel import compile_shared

_C_SRC = r"""
typedef long long i64;

/* sum over k < n of ((x[k] - p[k]) / bw[k])^2 in numpy's pairwise_sum
   order (numpy/_core/src/umath/loops_utils.h.src, PW_BLOCKSIZE 128) */
static double sq_sum(const double *x, const double *p, const double *bw,
                     i64 n)
{
    i64 i;
    int k;
    double t;
    if (n < 8) {
        double res = 0.;
        for (i = 0; i < n; i++) {
            t = (x[i] - p[i]) / bw[i];
            res += t * t;
        }
        return res;
    }
    if (n <= 128) {
        double r[8], res;
        for (k = 0; k < 8; k++) {
            t = (x[k] - p[k]) / bw[k];
            r[k] = t * t;
        }
        for (i = 8; i < n - (n % 8); i += 8) {
            for (k = 0; k < 8; k++) {
                t = (x[i + k] - p[i + k]) / bw[i + k];
                r[k] += t * t;
            }
        }
        res = ((r[0] + r[1]) + (r[2] + r[3])) +
              ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) {
            t = (x[i] - p[i]) / bw[i];
            res += t * t;
        }
        return res;
    }
    {
        i64 n2 = n / 2;
        n2 -= n2 % 8;
        return sq_sum(x, p, bw, n2) +
               sq_sum(x + n2, p + n2, bw + n2, n - n2);
    }
}

/* out[i, j] = sq_sum(x[i], p[j], bw[j]); row-major (n, d), (m, d),
   (m, d) in, (n, m) out */
void kde_sq_sums(i64 n, i64 m, i64 d, const double *x, const double *p,
                 const double *bw, double *out)
{
    i64 i, j;
    for (i = 0; i < n; i++)
        for (j = 0; j < m; j++)
            out[i * m + j] = sq_sum(x + i * d, p + j * d, bw + j * d, d);
}
"""

# -ffp-contract=off is load-bearing (see the module docstring). No
# -ffast-math and no -march=native: the sums must not depend on the host.
_CFLAGS = ["-O3", "-fPIC", "-shared", "-std=c99", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    lib = compile_shared("tpe_kde", _C_SRC, _CFLAGS)
    if lib is None:
        return None
    lib.kde_sq_sums.restype = None
    lib.kde_sq_sums.argtypes = [ctypes.c_longlong] * 3 + \
        [ctypes.c_void_p] * 4
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled sums, built or loaded on the first call; None where
    the host cannot provide them (no compiler, failed build)."""
    global _lib, _tried
    if not _tried:
        _tried = True
        _lib = _load()
    return _lib


def sq_dist_sums(x: np.ndarray, pts: np.ndarray,
                 bw: np.ndarray) -> Optional[np.ndarray]:
    """``np.sum(((x[:, None] - pts[None]) / bw[None]) ** 2, -1)`` of
    float64 ``x`` (n, D), ``pts`` and ``bw`` (m, D), bit for bit, as an
    (n, m) array; None without the compiled library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float64)
    pts = np.ascontiguousarray(pts, np.float64)
    bw = np.ascontiguousarray(bw, np.float64)
    (n, d), m = x.shape, len(pts)
    if pts.shape != (m, d) or bw.shape != (m, d):
        raise ValueError(f"x {x.shape}, pts {pts.shape} and bw {bw.shape} "
                         "need one dim count and pts.shape == bw.shape")
    out = np.empty((n, m))
    lib.kde_sq_sums(n, m, d, x.ctypes.data, pts.ctypes.data,
                    bw.ctypes.data, out.ctypes.data)
    return out
