"""K1's share of its roofline in the traced slice: the least time its
launches could take (bytes at each launch's batch over the card's HBM
bandwidth, ``peaks.k1_bound_s``) over the device time the trace gives
K1's kernel.  Every launch of a slice has one batch on the cells' paths
(frames x wave slots x modes); where the program's counter saw more than
one batch, or the trace holds no K1 kernel, there is nothing to read."""

from pbench import peaks
from pbench.trace import K1_KERNEL


def read(s):
    tr = s["trace"]
    if tr is None or len(s["k1_batches"]) != 1:
        return None
    rows = [v for k, v in tr["kernels"].items() if K1_KERNEL in k]
    n = sum(v[0] for v in rows)
    t = sum(v[1] for v in rows)
    if not n or t <= 0:
        return None
    return 100.0 * n * peaks.k1_bound_s(s["k1_batches"][0]) / t
