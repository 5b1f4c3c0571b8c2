"""Host time of the lookahead per coded frame of the traced run's window:
the program's MCTF and TPL stages (``key_tf``, ``key_tpl``, ``gop_tf``,
``gop_tpl``, ``gop_tpl_synth``) over the frames coded, read without the
profiler."""

STAGES = ("key_tf", "key_tpl", "gop_tf", "gop_tpl", "gop_tpl_synth")


def read(s):
    found = [s["stages"][k] for k in STAGES if k in s["stages"]]
    if not found or not s["frames"]:
        return None
    return 1000.0 * sum(found) / s["frames"]
