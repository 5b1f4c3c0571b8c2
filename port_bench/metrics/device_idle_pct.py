"""The share of the traced slice's wall time that no device operation
(kernel, copy or memset) covers: 100 x (1 - busy / window), busy being
the union of the device intervals and not the sum of their durations."""


def read(s):
    tr = s["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
