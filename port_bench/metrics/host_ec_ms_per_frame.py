"""Host entropy coding per coded frame of the traced run's window: the
program's ``host_ec`` stage seconds (host time between the stage's enter
and exit, waits for the copies it forces included) over the frames coded.
Read over the window, without the profiler, whose cost would double the
host time."""


def read(s):
    t = s["stages"].get("host_ec")
    if t is None or not s["frames"]:
        return None
    return 1000.0 * t / s["frames"]
