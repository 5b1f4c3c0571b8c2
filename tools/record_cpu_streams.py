#!/usr/bin/env python3
"""Record tests/golden/torch_cpu_streams.json: the sha1 digest of the
CPU's stream of every cpu-vs-cuda case of chip_smoke.py (phases 7, 12,
16, 20, 27, 31 and 34), and of the cases that phases 39-41 hold to the
CPU's digest alone (the CLI's main path at CIF x17 and its decoded
frames, the M4 levels-5 GOP), of phase 43's multi-stream cases (the
outputs of tests/test_torch_multistream.py's batched encodes), of
phase 45's stage-path streams (tests/test_torch_stage_path.py) and of
phase 47's feature-override streams
(tests/test_torch_feature_overrides.py).
chip_smoke.py holds the
card's stream of each case to its digest instead of encoding the case on
the CPU again; in phases 7-34 a card stream that does not match is
encoded on the CPU there and held to the parity rule, as before.

    python tools/record_cpu_streams.py      # about ten minutes on the CPU
    python tools/record_cpu_streams.py 43   # phase 43's only (a minute),
                                            # the other digests kept
    python tools/record_cpu_streams.py 45   # phase 45's only (a minute)
    python tools/record_cpu_streams.py 47   # phase 47's only (a minute)

Runs the same phase functions with the card's side on the CPU
(chip_smoke.CARD = "cpu"), collecting each stream's digest
(chip_smoke.RECORDED), then writes them all.  Remake the file when an
encode path that these phases drive changes its output.
"""
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import clips
    import chip_smoke as cs
    cs.CARD = "cpu"
    cs.RECORDED = {}
    only = {"43": cs.phase_multistream_small, "45": cs.phase_stage_small,
            "47": cs.phase_override_small}
    if len(argv) == 1 and argv[0] in only:
        with open(cs.CPU_STREAMS) as f:
            kept = {k: v for k, v in json.load(f).items()
                    if not k.startswith(f"{argv[0]}/")}
        only[argv[0]]()
        return write(cs, {**kept, **cs.RECORDED})
    if argv:
        print(f"record_cpu_streams: unknown arguments {argv}",
              file=sys.stderr)
        return 2
    # phases 7, 12 and 16 compare the packets of phases 5, 9 and 14 (the
    # frames main() gives them)
    cif17 = cs.synth_frames(17, *cs.CIF)
    cif = cif17[:cs.CIF_FRAMES]
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
    for key, digest in cs.digest_cases("cpu").items():
        cs.stored_digest(key, digest)
    with tempfile.TemporaryDirectory() as folder:
        ivf, decoded = cs.main_path_digests(cif17[:cs.MAIN_FRAMES], "cpu",
                                            folder)
    cs.stored_digest("39/ivf", ivf)
    cs.stored_digest("39/decoded", decoded)
    cs.phase_multistream_small()
    cs.phase_stage_small()
    cs.phase_override_small()
    return write(cs, cs.RECORDED)


def write(cs, digests):
    with open(cs.CPU_STREAMS, "w") as f:
        json.dump(dict(sorted(digests.items())), f, indent=1)
        f.write("\n")
    print(f"wrote {len(digests)} digests to {cs.CPU_STREAMS}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
