"""The spatial mesh axis over NCCL: one rank on each of 4 cards
(``launch.backend_for`` picks ``nccl`` for distinct cards), the meshes
(n_data, n_spatial) = (1, 2) on the launch's first two ranks, (1, 4) and
(2, 2).  The halo exchange and the all-gather along D, with their
backwards, on integer-valued float64 slabs: exact.  ``VxmConfig()``'s
widths at 64^3 (global B = n_data), the flow head scaled so that the
warps move voxels more than a plane across the slabs' edges, against one
process on the whole batch on the first card:
``register``'s slabs put together within 1e-5 max-abs, the metrics of 2
steps within 1e-5 relative, every rank's parameters and Adam state bit for
bit alike, a rank's kernel launches a step and a call exact.

Skips without 4 CUDA cards.  On a machine with them (and no JAX), run:
    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_spatial_nccl_gpu.py
(``-s`` shows each mesh's times and bytes a step, by rank, as one JSON
line)."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import backend_for, launch
from dfmir_tpu_torch.parallel.mesh import batch_slice

pytestmark = pytest.mark.gpu

DEVICES = [f"cuda:{i}" for i in range(4)]
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2)}
SIZE = 64
CFG = dict(vol_size=SIZE)    # VxmConfig()'s widths
GAIN = 4e5                   # the flow head N(0, 1e-5) -> N(0, 4)
TOL = 1e-5
LIMIT = 600.0
S, LOHI = 16, (2, 1)         # the exchanges' slabs: 16 planes, halo (2, 1)
ZERO = dict.fromkeys(warp_cuda.LAUNCHES, 0)
REG3D = dict(ZERO, **{warp_cuda.VECINT3D_FWD: 1, warp_cuda.FWD3D: 1})
STEP3D = dict(REG3D, **{warp_cuda.VECINT3D_BWD: 1, warp_cuda.DFLOW3D: 1})


def volumes():
    """The global tensors ``checks.spatial_pieces`` slices, float64."""
    g = torch.Generator().manual_seed(0)

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g).double()

    def smooth(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    out = {"x": ints(2, 2, S, 6, 5), "halo_lohi": LOHI,
           "flow": smooth(2, 3, S, 8, 6) * 0.6,
           "flow2": smooth(2, 3, S // 2, 4, 3),
           "g_down": smooth(2, 3, S // 2, 4, 3),
           "g_up": smooth(2, 3, S, 8, 6),
           "pred": torch.rand((2, 1, S, 7, 6), generator=g,
                              dtype=torch.float64),
           "target": torch.rand((2, 1, S, 7, 6), generator=g,
                                dtype=torch.float64)}
    for _, n in MESHES.values():
        out[f"halo_w_{n}"] = ints(2, 2, n * (S // n + sum(LOHI)), 6, 5)
        out[f"gather_w_{n}"] = ints(n, 2, 2, S, 6, 5)
    return out


@pytest.fixture(scope="module")
def ranks():
    if torch.cuda.device_count() < len(DEVICES):
        pytest.skip(f"needs {len(DEVICES)} CUDA cards")
    assert backend_for(DEVICES) == "nccl"
    vols = volumes()
    rng = np.random.default_rng(4)
    A, B = (torch.from_numpy(rng.random((2, 1, SIZE, SIZE, SIZE)).astype(
        np.float32)) for _ in range(2))
    cases, jobs = [], {}
    for name, (n_data, n) in MESHES.items():
        v = dict(vols, halo_w=vols[f"halo_w_{n}"],
                 gather_w=vols[f"gather_w_{n}"])
        cases.append((f"pieces-{name}", "spatial_pieces",
                      {"n_data": n_data, "n_spatial": n, "vols": v}))
        batch = (A[:n_data], B[:n_data])
        jobs[name] = dict(cfg=dict(CFG), seed=0, flow_gain=GAIN,
                          batches=[batch] * 2, register=batch,
                          n_data=n_data, n_spatial=n)
        cases.append((name, "vxm_spatial_steps", {"job": jobs[name]}))
    out = launch(checks.run_cases, DEVICES, (cases,), LIMIT)
    singles = {name: checks.vxm_spatial_steps(None, dict(job,
                                                          device=DEVICES[0]))
               for name, job in jobs.items()}
    return vols, out, singles


def reports(ranks, name):
    return [r[name] for r in ranks[1] if r[name].get("in_mesh", True)]


@pytest.mark.parametrize("mesh", MESHES)
def test_halo_and_gather_over_nccl(ranks, mesh):
    vols = ranks[0]
    n_data, n = MESHES[mesh]
    reps = reports(ranks, f"pieces-{mesh}")
    assert len(reps) == n_data * n
    lo, hi = LOHI
    k = S // n
    span = k + lo + hi
    x = vols["x"].clone().requires_grad_(True)
    padded = F.pad(x, (0, 0, 0, 0, lo, hi))
    w = vols[f"halo_w_{n}"]
    sum((padded[:, :, s * k:s * k + span]
         * w[:, :, s * span:(s + 1) * span]).sum() for s in range(n)
        ).backward()
    gather_grad = vols[f"gather_w_{n}"].sum(0)
    for r in reps:
        d, s = r["data_rank"], r["spatial_rank"]
        mine = batch_slice(padded.detach(), d, n_data)
        assert torch.equal(r["halo"][0], mine[:, :, s * k:s * k + span])
        assert torch.equal(r["halo"][1], batch_slice(
            x.grad, d, n_data)[:, :, s * k:(s + 1) * k])
        assert torch.equal(r["gather"][0], batch_slice(vols["x"], d, n_data))
        assert torch.equal(r["gather"][1], batch_slice(
            gather_grad, d, n_data)[:, :, s * k:(s + 1) * k])


def assembled(reps, i):
    """The ranks' slabs of ``register``'s output i, put back together:
    along D in spatial order, the data ranks along the batch."""
    n_data = 1 + max(r["data_rank"] for r in reps)
    return torch.cat([
        torch.cat([r["register"][i] for r in sorted(
            reps, key=lambda q: q["spatial_rank"]) if r["data_rank"] == d],
            dim=2) for d in range(n_data)])


@pytest.mark.parametrize("mesh", MESHES)
def test_engine_over_nccl_matches_one_process(ranks, mesh):
    n_data, n = MESHES[mesh]
    reps = reports(ranks, mesh)
    single = ranks[2][mesh]
    assert len(reps) == n_data * n
    reg = [float((assembled(reps, i) - single["register"][i]).abs().max())
           for i in (0, 1)]
    flow_max = float(single["register"][1].abs().max())
    print(json.dumps({
        "mesh": mesh, "size": SIZE, "backend": backend_for(DEVICES),
        "register_max_abs_vs_one_process": reg, "flow_max_vox": flow_max,
        "metrics_by_step": reps[0]["metrics"],
        "one_process_metrics_by_step": single["metrics"],
        "step_ms_by_rank": [r["ms"] for r in reps],
        "one_process_step_ms": single["ms"],
        "register_ms_by_rank": [r["register_ms"] for r in reps],
        "bytes_sent_per_step_by_rank": [r["bytes_sent"][-1] for r in reps],
        "exchange_host_s_per_step_by_rank": [r["exchange_s"][-1]
                                             for r in reps],
        "peak_bytes_by_rank": [r["peak_bytes"] for r in reps]}))
    assert max(reg) <= TOL, reg
    # the flows reach across the slabs' edges
    assert flow_max > 1.0
    for i, want in enumerate(single["metrics"]):
        for k, v in want.items():
            got = reps[0]["metrics"][i][k]
            assert abs(got - v) <= TOL * abs(v), (i, k, got, v)
    for r in reps:
        assert r["register_launches"] == REG3D
        assert all(c == STEP3D for c in r["launches"])
        for x, y in zip(reps[0]["checksums"], r["checksums"]):
            assert torch.equal(x, y)
        assert r["bytes_sent"][-1]["halo"] > 0
        assert r["bytes_sent"][-1]["gather"] > 0
