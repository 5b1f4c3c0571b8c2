#!/usr/bin/env python3
"""Record tests/golden/torch_cpu_streams.json: the sha1 digest of the
CPU's stream of every cpu-vs-cuda case of chip_smoke.py (phases 7, 12,
16, 20, 27, 31 and 34).  chip_smoke.py holds the card's stream of each
case to its digest instead of encoding the case on the CPU again; a card
stream that does not match is encoded on the CPU there and held to the
parity rule, as before.

    python tools/record_cpu_streams.py      # a few minutes on the CPU

Runs the same phase functions with the card's side on the CPU
(chip_smoke.CARD = "cpu"), collecting each stream's digest
(chip_smoke.RECORDED), then writes them all.  Remake the file when an
encode path that these phases drive changes its output.
"""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import clips
    import chip_smoke as cs
    cs.CARD = "cpu"
    cs.RECORDED = {}
    # phases 7, 12 and 16 compare the packets of phases 5, 9 and 14 (the
    # frames main() gives them)
    cif = cs.synth_frames(cs.CIF_FRAMES, *cs.CIF)
    cs.phase_cpu_vs_cuda(cif, cs.encode(cif, *cs.CIF, "cpu"), None)
    key_cif = cif[:1] + [clips.screen_frame(*cs.CIF, seed=1)]
    cs.phase_cpu_vs_cuda_m6(
        key_cif, cs.encode(key_cif, *cs.CIF, "cpu", 6, batched=False), None)
    cs.phase_cpu_vs_cuda_filters(
        key_cif, cs.encode(key_cif, *cs.CIF, "cpu", 6, batched=False,
                           **cs.FILTERS), None, None)
    cs.phase_gop_cpu_vs_cuda()
    cs.phase_m6_tools_cpu_vs_cuda()
    cs.phase_m4_cpu_vs_cuda()
    cs.phase_post_cpu_vs_cuda()
    with open(cs.CPU_STREAMS, "w") as f:
        json.dump(dict(sorted(cs.RECORDED.items())), f, indent=1)
        f.write("\n")
    print(f"wrote {len(cs.RECORDED)} digests to {cs.CPU_STREAMS}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
