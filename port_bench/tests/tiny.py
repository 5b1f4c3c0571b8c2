"""A copy of the benchmark's files in a temporary root with two tiny cells
added as files and entries, for tests that drive a whole run on the
CPU."""
import json
import os
import shutil

from pbench import spec

TINY_CONFIGS = {
    "tiny_ai": dict(source_width=64, source_height=64, enc_mode=10, qp=35,
                    intra_period_length=0, enable_dlf_flag=True),
    "tiny_ra": dict(source_width=64, source_height=64, enc_mode=10, qp=35,
                    intra_period_length=15, hierarchical_levels=3,
                    enable_dlf_flag=True, cdef_level=1, enable_tf=1,
                    enable_tpl_la=1),
}
TINY_TRAFFIC = {
    "tiny_chunk2": dict(entry="send_pictures", frames_per_call=2,
                        segment_frames=4, pool_frames=4, check_frames=0),
    "tiny_seq16": dict(entry="send_picture", segment_frames=16,
                       pool_frames=16, check_frames=2),
}
TINY_CELLS = {"tiny.ai": ("tiny_ai", "tiny_chunk2"),
              "tiny.ra": ("tiny_ra", "tiny_seq16")}


def make(tmp) -> str:
    """Copy BENCHMARK.json and the harness's folder under ``tmp`` and add
    the tiny cells there; returns the new root."""
    root = os.path.join(str(tmp), "checkout")
    here = spec.bench_dir(spec.ROOT)
    shutil.copytree(here, spec.bench_dir(root),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    bench = spec.load_benchmark()
    content = json.load(open(os.path.join(
        here, "traffic", bench["workloads"][0]["traffic"] + ".json")))["content"]
    # faster motion than the cells' clip, so that neighbouring frames of
    # the tiny clip differ well beyond the coding noise
    content = dict(content, motion_x=0.8)
    for name, enc in TINY_CONFIGS.items():
        rel = f"{spec.BENCH_REL}/configs/{name}.json"
        with open(os.path.join(root, rel), "w") as f:
            json.dump(dict(name=name, encoder=enc), f)
        bench["configs"].append(dict(name=name, source="tests", file=rel,
                                     reduced=[], why="tests"))
    for name, t in TINY_TRAFFIC.items():
        with open(os.path.join(spec.bench_dir(root), "traffic",
                               name + ".json"), "w") as f:
            json.dump(dict(t, content=content), f)
    for name, (cfg, traffic) in TINY_CELLS.items():
        with open(os.path.join(spec.bench_dir(root), "cells",
                               name + ".json"), "w") as f:
            json.dump(dict(limits=dict(missing_frames=0, decode_errors=0,
                                       mismatch_px=0, mean_shift_y=0.25,
                                       mse_y_worst=40.0)), f)
        bench["workloads"].append(dict(name=name, config=cfg,
                                       traffic=traffic, chips=1, why="tests"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
