"""One-off: chip_smoke's GBDT/VW mesh phases (mesh_dense, mesh_sparse on a
200,000-row cut, mesh_vw on random rows, mesh_ranker, mesh_checkpoint) and
the data 2 x tensor 2 phase of the DNN ranks, on generated inputs; then the
new CUDA tests. Output tee'd by the caller."""
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


FAILS = []


def record(msg):
    FAILS.append(msg)
    print("FAIL:", msg, flush=True)


def dnn_rank(mesh, label, work):
    specs = cs.dnn_mesh_specs
    cs.dnn_mesh_specs = lambda world: (
        {"mesh_gbdt_axes": specs(world)["mesh_gbdt_axes"]} if world > 1
        else {})
    return cs.dnn_mesh_rank(mesh, label, work)


def make_inputs():
    from mmlspark_tpu_torch.gbdt import sparse

    t0 = time.perf_counter()
    X, y = cs.higgs_like(cs.N_MAIN, cs.SEED)
    inputs = {"dense": cs.mesh_save("dense", X=X.astype(np.float32), y=y)}
    del X, y
    Xr, rel, qid = cs.mslr_like(cs.N_RANK, cs.SEED)
    n_q = int(qid[-1]) + 1
    is_val = (np.random.default_rng(cs.SEED + 1).random(n_q) < 0.1)[qid]
    inputs["ranker"] = cs.mesh_save("ranker", X=Xr.astype(np.float32),
                                    rel=rel, qid=qid, is_val=is_val)
    del Xr
    ip, ix, vv, sy = cs.make_csr_text(200_000, cs.W_SPARSE, 50, 1)
    ds = sparse.SparseDataset.from_csr(ip, ix, vv, cs.W_SPARSE, 64)
    inputs["sparse"] = cs.mesh_save(
        "sparse", y=sy, num_features=np.int64(ds.num_features),
        **{k: getattr(ds, k) for k in (
            "indptr", "indices", "values", "feat_offset", "thresholds",
            "zero_local", "bin_of_nnz", "row_of_nnz")})
    rng = np.random.default_rng(0)
    n, k = 200_000, 39
    inputs["vw"] = cs.mesh_save(
        "vw", indices=rng.integers(0, 1 << cs.VW_BITS, (n, k)).astype(np.int32),
        values=np.floor(np.log1p(rng.random((n, k)) * 50) ** 2)
        .astype(np.float32) * 0.1,
        labels=np.where(rng.random(n) < 0.3, 1.0, -1.0).astype(np.float32),
        weights=np.ones(n, np.float32))
    cs.log({"phase": "driver_inputs", "seconds": time.perf_counter() - t0})
    return inputs


def main():
    import torch

    from mmlspark_tpu_torch.gbdt import sparse
    from mmlspark_tpu_torch.parallel import launch

    t_all = time.perf_counter()
    cs.fail = record
    hdr = cs.header(torch)
    smi = hdr["smi"].splitlines()[0]
    orig_spawn = launch.spawn

    def spawn(target, world, workdir, kwargs=None, **kw):
        if target == "chip_smoke:dnn_mesh_rank":
            target = "mesh_driver:dnn_rank"
            kw["path"] = [HERE, *kw.get("path", ())]
        return orig_spawn(target, world, workdir, kwargs, **kw)
    launch.spawn = spawn
    inputs = make_inputs()
    t0 = time.perf_counter()
    dnn_pending = cs.dnn_mesh_start(torch)
    dnn_runs = []
    mesh = cs.mesh_phases(torch, inputs, smi,
                          after_ranks=lambda: dnn_runs.extend(dnn_pending()))
    refs = {"gbdt_axes": {"dense": mesh["mesh_dense"]["single_fused"],
                          "vw": mesh["mesh_vw"]["want"]}}
    paths = cs._mesh_gbdt_axes_gates(dnn_runs, refs, smi)
    for got in mesh.values():
        paths.update(got["paths"])
    cs.log({"phase": "driver_mesh", "seconds": time.perf_counter() - t0,
            "paths": paths})
    cs.mesh_cleanup()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                        "-m", "cuda", "tests/test_torch_cuda.py", "-k",
                        "replays_its_graph or mesh_fits_on_the_card or "
                        "sharded_fused_body or nccl_mesh_gathers or "
                        "lambdarank_gradient"], cwd=ROOT,
                       capture_output=True, text=True)
    print(r.stdout[-6000:], r.stderr[-3000:], flush=True)
    cs.log({"phase": "driver_cuda_tests", "rc": r.returncode,
            "seconds": time.perf_counter() - t0})
    cs.log({"phase": "driver_done", "seconds": time.perf_counter() - t_all,
            "fails": FAILS})
    return 1 if FAILS or r.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
