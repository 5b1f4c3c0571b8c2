"""Host time of P1 and P2's dispatch per inter frame of the traced run's
window: the program's ``dispatch_inter`` stage seconds over the inter
frames coded, read without the profiler."""


def read(s):
    t = s["stages"].get("dispatch_inter")
    if t is None or not s["inter_frames"]:
        return None
    return 1000.0 * t / s["inter_frames"]
