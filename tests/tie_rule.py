"""The forward-transform tie rule, shared by the port's tests and
chip_smoke.py.

Float32 sums taken in another order than the reference's round a
coefficient whose exact value lies on a .5 tie the other way.  So a
coefficient may differ by at most 1, and only where its float64 value
lies within TIE_EPS of a half-integer.  Imports numpy only, so it also
runs where JAX is not installed.
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
