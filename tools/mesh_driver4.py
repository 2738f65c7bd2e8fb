"""One-off on four cards: mesh_driver's phases (NCCL a card: mesh_dense,
mesh_sparse on a 200,000-row cut, mesh_vw, mesh_ranker, mesh_checkpoint;
mesh_gbdt_axes on data 2 x tensor 2), then an A/B of a rank's sharded
dense fused fit with its trees captured (the port) and eager (capture
turned off by patching ``collectives_capturable``), captured / eager /
eager / captured in one launch; then the four-card CUDA tests."""
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402
import mesh_driver as md  # noqa: E402

def _dump_later():
    import faulthandler

    faulthandler.dump_traceback_later(150, exit=False)


def dnn_rank(mesh, label, work):
    _dump_later()
    return md.dnn_rank(mesh, label, work)


def mesh_rank(mesh, inputs, label):
    _dump_later()
    return cs.mesh_rank(mesh, inputs, label)


def ab_rank(mesh, inputs):
    import torch

    from mmlspark_tpu_torch.gbdt import booster as bst
    from mmlspark_tpu_torch.parallel import mesh as pm

    d = cs.mesh_load(inputs)
    X, y = np.asarray(d["X"], dtype=np.float64), np.asarray(d["y"])
    cs.mesh_warm(torch, mesh)
    orig = pm.collectives_capturable
    out = []
    for mode in ("captured", "eager", "eager", "captured"):
        pm.collectives_capturable = orig if mode == "captured" \
            else (lambda m: False)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b = bst.train(cs.mesh_dense_params(cs.MESH_ITERS_DENSE), X, y,
                          mesh=mesh)
            torch.cuda.synchronize()
            out.append((mode, time.perf_counter() - t0, b.to_string()))
        finally:
            pm.collectives_capturable = orig
    return out


def main():
    import torch

    from mmlspark_tpu_torch.parallel import launch

    cs.fail = md.record
    t_all = time.perf_counter()
    smi = cs.header(torch)["smi"].splitlines()[0]
    orig_spawn = launch.spawn

    def spawn(target, world, workdir, kwargs=None, **kw):
        target = {"chip_smoke:dnn_mesh_rank": "mesh_driver4:dnn_rank",
                  "chip_smoke:mesh_rank": "mesh_driver4:mesh_rank"}[target]
        kw["path"] = [HERE, *kw.get("path", ())]
        return orig_spawn(target, world, workdir, kwargs, **kw)
    launch.spawn = spawn
    inputs = md.make_inputs()
    t0 = time.perf_counter()
    dnn_pending = cs.dnn_mesh_start(torch)
    dnn_runs = []
    mesh = cs.mesh_phases(torch, inputs, smi,
                          after_ranks=lambda: dnn_runs.extend(dnn_pending()))
    refs = {"gbdt_axes": {"dense": mesh["mesh_dense"]["single_fused"],
                          "vw": mesh["mesh_vw"]["want"]}}
    cs._mesh_gbdt_axes_gates(dnn_runs, refs, smi)
    cs.log({"phase": "driver_mesh", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ranks = orig_spawn("mesh_driver4:ab_rank", 4,
                       os.path.join(cs.mesh_workdir(), "ab"),
                       {"inputs": inputs["dense"]}, device="cuda",
                       backend="nccl", timeout=600, path=[HERE, ROOT])
    for r, res in enumerate(ranks):
        cs.log({"phase": "ab_capture", "card": smi, "rank": r,
                "fit_seconds": [(m, s) for m, s, _ in res],
                "models_equal_single": [m == refs["gbdt_axes"]["dense"]
                                        for _, _, m in res]})
        if any(m != refs["gbdt_axes"]["dense"] for _, _, m in res):
            md.record(f"ab_capture rank {r}: a model differs")
    cs.log({"phase": "ab_capture", "seconds": time.perf_counter() - t0})
    cs.mesh_cleanup()
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                        "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "nccl_sub_meshes or replays_its_graph"], cwd=ROOT,
                       capture_output=True, text=True)
    print(r.stdout[-5000:], r.stderr[-2000:], flush=True)
    cs.log({"phase": "driver_done", "seconds": time.perf_counter() - t_all,
            "tests_rc": r.returncode, "fails": md.FAILS})
    return 1 if md.FAILS or r.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
