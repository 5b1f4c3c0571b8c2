"""The tie rules of the forward transform and of MCTF, shared by the
port's tests and chip_smoke.py.

Float32 sums taken in another order than the reference's round a
coefficient whose exact value lies on a .5 tie the other way.  So a
coefficient may differ by at most 1, and only where its float64 value
lies within TIE_EPS of a half-integer.  A temporally filtered pixel (a
float32 weighted average with exp weights) is held the same way, within
PIXEL_TIE_EPS.  Imports numpy only, so it also runs where JAX is not
installed.

TIE_EPS is the rule for 8-bit residuals.  At 10 bits a coefficient
reaches 2^17, where one float32 step (2^-6) is wider than TIE_EPS, so two
honest summation orders may round a value that lies more than TIE_EPS
from a half-integer differently.  10-bit residuals are therefore held to
``tie_mismatches_bounded``: a coefficient may differ by one only where
its exact value lies within ``coeff_error_bound`` of a half-integer, the
standard float32 error bound of the two matrix products.
"""
import numpy as np

TIE_EPS = 1e-2


def exact_coeffs(resid, fv, fh):
    """float64 value of fv @ resid @ fh.T for a (B, H, W) residual batch
    (already flipped where the transform type flips)."""
    return np.einsum("ih,bhw,jw->bij", np.asarray(fv, np.float64),
                     np.asarray(resid, np.float64),
                     np.asarray(fh, np.float64))


def tie_mismatches(got, ref, exact):
    """(mismatch count, max |diff|) of two integer coefficient arrays;
    raises AssertionError unless every mismatch is one step at a value
    within TIE_EPS of a half-integer."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    bad = diff > 0
    frac = np.abs(np.abs(exact - np.floor(exact)) - 0.5)
    maxd = int(diff.max(initial=0))
    worst = float(frac[bad].max(initial=0.0))
    if maxd > 1 or worst > TIE_EPS:
        raise AssertionError(f"coefficient mismatch off a rounding tie: "
                             f"max |diff| {maxd}, worst distance to .5 "
                             f"{worst}")
    return int(bad.sum()), maxd


PIXEL_TIE_EPS = 1e-3


def pixel_flips(got, ref, exact):
    """(flip count, max |diff|) of two rounded pixel arrays (the MCTF
    output); raises AssertionError unless every flip is one step at a
    pixel whose exact (float64) value lies within PIXEL_TIE_EPS of a
    half-integer."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    bad = diff > 0
    exact = np.asarray(exact, np.float64)
    frac = np.abs(np.abs(exact - np.floor(exact)) - 0.5)
    maxd = int(diff.max(initial=0))
    worst = float(frac[bad].max(initial=0.0))
    if maxd > 1 or worst > PIXEL_TIE_EPS:
        raise AssertionError(f"pixel mismatch off a rounding tie: max "
                             f"|diff| {maxd}, worst distance to .5 {worst}")
    return int(bad.sum()), maxd


U32 = 2.0 ** -24   # float32 unit roundoff


def coeff_error_bound(resid, fv, fh):
    """float64 bound, per coefficient, on the float32 error of
    fv @ resid @ fh.T computed as two products of nv- and nh-term dot
    products (any summation order, with or without fused multiply-add):
    (nv + nh + 1) * u * (|fv| @ |resid| @ |fh|.T), u = 2^-24; the extra
    term covers the rounding of the result itself.  resid as for
    ``exact_coeffs``."""
    fv = np.abs(np.asarray(fv, np.float64))
    fh = np.abs(np.asarray(fh, np.float64))
    terms = fv.shape[1] + fh.shape[1] + 1
    return terms * U32 * np.einsum("ih,bhw,jw->bij", fv,
                                   np.abs(np.asarray(resid, np.float64)),
                                   fh)


def tie_mismatches_bounded(got, ref, exact, bound):
    """(mismatch count, max |diff|, largest distance to .5 among the
    mismatches) of two integer coefficient arrays of 10-bit residuals;
    raises AssertionError unless every mismatch is one step at a value
    whose distance to a half-integer is within its ``bound``
    (coeff_error_bound): there the two float32 results may fall on
    either side of the tie."""
    diff = np.abs(np.asarray(got, np.int64) - np.asarray(ref, np.int64))
    bad = diff > 0
    frac = np.abs(np.abs(exact - np.floor(exact)) - 0.5)
    maxd = int(diff.max(initial=0))
    off = bad & (frac > bound)
    if maxd > 1 or off.any():
        raise AssertionError(
            f"coefficient mismatch off a rounding tie: max |diff| {maxd}, "
            f"{int(off.sum())} mismatches farther from .5 than the float32 "
            f"error bound (worst {float(frac[off].max(initial=0.0))})")
    return int(bad.sum()), maxd, float(frac[bad].max(initial=0.0))
