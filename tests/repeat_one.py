"""Repeat one test function many times in one process and count its passes.

    python tests/repeat_one.py tests/test_torch_cuda.py \
        test_mega_program_evicted_while_another_thread_replays 50 [--root DIR]

A rare race shows more often when a test runs many times in one process
than in whole-suite runs. ``--root`` imports ``mmlspark_tpu_torch`` and the
test file from another checkout (e.g. the parent commit unpacked with
``git archive``), so both trees run the same way. A ``cuda_device``
argument gets ``torch.device("cuda")``; other fixtures are not supported.
Prints one JSON line: runs, passes, failures, seconds and the first errors.
"""

import argparse
import importlib.util
import inspect
import json
import pathlib
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("test_file")
    ap.add_argument("test_name")
    ap.add_argument("runs", type=int)
    ap.add_argument("--root", default=".")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "tests"))
    path = root / args.test_file
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = getattr(mod, args.test_name)
    kwargs = {}
    if "cuda_device" in inspect.signature(fn).parameters:
        import torch

        kwargs["cuda_device"] = torch.device("cuda")
    passed, errors = 0, []
    t0 = time.perf_counter()
    for _ in range(args.runs):
        try:
            fn(**kwargs)
            passed += 1
        except Exception as e:  # noqa: BLE001 — counted and reported
            errors.append(repr(e)[:300])
    pkg = sys.modules.get("mmlspark_tpu_torch")
    print(json.dumps({"test": args.test_name, "root": str(root),
                      "package": getattr(pkg, "__file__", None),
                      "runs": args.runs, "passed": passed,
                      "failed": args.runs - passed,
                      "seconds": time.perf_counter() - t0,
                      "errors": errors[:3]}))
    return 0 if passed == args.runs else 1


if __name__ == "__main__":
    sys.exit(main())
