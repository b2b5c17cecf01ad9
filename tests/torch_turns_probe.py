"""Phase 3's and phase 4's B=1 generate (chip_smoke.phase_end_to_end: the
K=1 int4 path and the int8 K=4 path with int8 KV) of an earlier checkout and
of this one, on the card, in turns (earlier, this, this, earlier), each turn
a process of its own that imports its checkout's package and chip_smoke.py
and builds its kernels. From the repo root of this checkout:

    git archive <commit> | tar -x -C <dir>
    python3 tests/torch_turns_probe.py <dir>

Prints each turn's end-to-end lines: ms a step and tok/s (graph path, and
against the host loop), the decode graph's pool MB and launches a replay.
Exits non-zero if a turn fails.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = ("turn ", "end to end", "graph of generate", "graph path against")


def turn(root: str, label: str) -> None:
    """One turn in this process: root's chip_smoke phases 3 and 4."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from llm_inference_lab_tpu_torch import build

    build.build_all()
    dev = torch.device("cuda", 0)
    paths = list(cs.PATH_KERNELS)
    cs.log(f"turn {label} {root}")
    eng, _ = cs.phase_end_to_end(dev, False, cs.INT4_CFG, paths[0], "3B int4 + 1B draft, K=1")
    del eng
    torch.cuda.empty_cache()
    cs.phase_end_to_end(dev, False, cs.INT8_CFG, paths[2], "3B int8 + 1B, K=4, int8 KV")


def main(argv) -> int:
    if argv and argv[0] == "--turn":
        turn(os.path.abspath(argv[1]), argv[2])
        return 0
    earlier = os.path.abspath(argv[0])
    for i, root in enumerate([earlier, ROOT, ROOT, earlier]):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root, str(i)],
                           capture_output=True, text=True)
        print("\n".join(ln for ln in r.stdout.splitlines() if ln.startswith("[") and
                        any(k in ln for k in KEEP)), flush=True)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
