"""Device kernels per coded frame of the traced slice (a fresh segment's
first burst), copies and memsets apart."""


def read(s):
    tr = s["trace"]
    if tr is None or not s["slice_frames"]:
        return None
    return tr["launches"] / s["slice_frames"]
