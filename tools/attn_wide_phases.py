"""One-off: chip_smoke's attention phases alone on one card (the build with
its ptxas gates, attn_kernel and attn_bwd_kernel with the head dims above
the tuned layouts, the encoder trained at head dims 384 and 512 and served
at 640), each timed, then the flash-attention CUDA tests. Run from the root
of a checkout on a host with a card; tee its output:

    python3 tools/attn_wide_phases.py 2>&1 | tee attn_wide.log
"""
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

FAILS = []


def record(msg):
    FAILS.append(msg)
    print("FAIL:", msg, flush=True)


def main() -> int:
    import torch

    cs.fail = record
    t_start = time.perf_counter()
    hdr = cs.header(torch)
    smi = hdr["smi"].splitlines()[0]
    for phase in (cs.attn_kernel_phase, cs.attn_bwd_kernel_phase,
                  cs.train_wide_heads, cs.serve_wide_heads):
        t0 = time.perf_counter()
        args = (torch,) if phase.__name__.startswith("attn") else (torch, smi)
        phase(*args)
        cs.log({"phase": phase.__name__, "seconds": time.perf_counter() - t0})
    cs.log({"phase": "all", "seconds": time.perf_counter() - t_start})
    t0 = time.perf_counter()
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests", "test_torch_cuda.py"),
         "-k", "flash or k5 or dense_attention"], cwd=ROOT)
    cs.log({"phase": "cuda_tests", "rc": tests.returncode,
            "seconds": time.perf_counter() - t0})
    print("FAILS", len(FAILS), flush=True)
    return 1 if FAILS or tests.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
