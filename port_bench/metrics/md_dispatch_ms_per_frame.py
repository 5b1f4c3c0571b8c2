"""Host time of the intra wave loop's dispatch per coded frame of the
traced run's window: the program's ``device_dispatch`` stage seconds
(``send_pictures``' launch of a chunk's frame program) over the frames
coded, read without the profiler."""


def read(s):
    t = s["stages"].get("device_dispatch")
    if t is None or not s["frames"]:
        return None
    return 1000.0 * t / s["frames"]
