"""The port's multi-process paths on the CPU: gloo process groups of 2 and
4 processes (``parallel.mesh.init_distributed`` from the environment, as
``torchrun`` sets it).

* the ring over a process group (``batch_isend_irecv`` round the ring,
  the all-gathers) against the same ring run in turn in one process
  (``LocalRing``), forward and backward, ragged and with a key mask, and
  the Swin windows split over the group; at 2 and 4 ranks;
* data parallelism: a GMFlow step and a RAFT-basic step (batch norm live,
  ``add_noise`` on), each rank on its half of the batch, against the
  single-process step on the whole batch;
* ``model_parallel = 2``: two GMFlow steps over a model group of two
  processes against the unsharded steps, and a (2 data x 2 model) mesh of
  four against the single-process step on the whole batch;
* the training CLI in two processes (``train.cli.main`` joins and leaves
  the group itself).

Each case runs this file as a script in every process (``torch`` only,
one thread each), which writes its results to an ``.npz``; the test holds
them against the reference computed here. Every process must exit with
rc 0 within its timeout. Tolerances are stated per test.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from opticalflowfromdepth_torch.parallel import mesh as pm  # noqa: E402
from opticalflowfromdepth_torch.parallel import sequence as seq  # noqa: E402
from opticalflowfromdepth_torch.train import gmflow_train as gt  # noqa: E402
from opticalflowfromdepth_torch.train import raft_train as rt  # noqa: E402

H, W = 32, 48
GM = dict(batch_size=2, image_size=(H, W), mixed_precision=False,
          num_transformer_layers=2, num_steps=10)
RAFT = dict(batch_size=2, image_size=(H, W), mixed_precision=False,
            iters=2, add_noise=True, freeze_bn=False, num_steps=10)
TIMEOUT = 300


# ---------------------------------------------------------------------------
# what every process computes (and the single-process reference)
# ---------------------------------------------------------------------------

def ring_inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    mask = torch.from_numpy((rng.uniform(size=(2, 43)) > 0.3).astype(
        np.float32))
    mask[:, 0] = 1.0
    return dict(q=f(2, 43, 16), k=f(2, 37, 16), v=f(2, 37, 3), g=f(2, 43, 3),
                mask=mask, kq=f(2, 43, 16), kv=f(2, 43, 3), wq=f(16, 24, 16),
                wk=f(16, 24, 16), wv=f(16, 24, 16), wg=f(16, 24, 16))


def ring_results(group):
    """The ring's output and gradients (ragged Lq 43 / Lk 37), the ring
    under a key mask, and 4 images' shifted windows split over the
    group."""
    x = ring_inputs()
    q, k, v = (x[n].clone().requires_grad_() for n in "qkv")
    out = seq.ring_softmax_matmul(q, k, v, group)
    out.backward(x["g"])
    masked = seq.ring_softmax_matmul(x["q"], x["kq"], x["kv"], group,
                                     kmask=x["mask"])
    wq, wk, wv = (x[n].clone().requires_grad_() for n in ("wq", "wk", "wv"))
    win = seq.sharded_window_attention(wq, wk, wv, group, (2, 4, 6, 2, 3))
    win.backward(x["wg"])
    return dict(out=out, dq=q.grad, dk=k.grad, dv=v.grad, masked=masked,
                win=win, dwq=wq.grad, dwk=wk.grad, dwv=wv.grad)


def batch(seed, b=2):
    """A seeded batch of ``b`` smooth image pairs at H x W, NCHW."""
    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (2 * b, 3, 4, 6)).astype(
        np.float32))
    img = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear",
                                          align_corners=False)
    return dict(image1=img[:b].contiguous(), image2=img[b:].contiguous(),
                flow=torch.from_numpy(rng.normal(0, 3, (b, 2, H, W)).astype(
                    np.float32)),
                valid=torch.from_numpy((rng.uniform(size=(b, H, W)) > 0.1)
                                       .astype(np.float32)),
                label=torch.eye(4)[:b])


def rows(b, mesh):
    """This process's rows of a batch of the whole batch size."""
    n = b["image1"].shape[0] // mesh.data_world
    return {k: v[mesh.data_rank * n:(mesh.data_rank + 1) * n]
            for k, v in b.items()}


def run_steps(module, cfg, mesh, seeds, gen_seed=None):
    """Steps of ``module`` (gmflow_train or raft_train) on the batches of
    ``seeds`` (this process's rows of them); per step the metrics, the raw
    gradients before the clip, and the parameters after the update."""
    state = module.init_state(cfg, seed=1, device="cpu", mesh=mesh)
    step = module.make_train_step(cfg, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(gen_seed or 0)
    grads, out = [], {}
    adam_step = state.optimizer.step

    def keep():
        grads.append([g.clone() for g in state.optimizer.grads()])
        return adam_step()
    state.optimizer.step = keep
    for i, s in enumerate(seeds):
        state, m = step(state, rows(batch(s), mesh), gen)
        for k, v in m.items():
            out[f"m{i}_{k}"] = v
        for j, g in enumerate(grads[-1]):
            out[f"g{i}_{j}"] = g
        for j, p in enumerate(state.model.parameters()):
            out[f"p{i}_{j}"] = p.detach().clone()
        for name, b in state.model.named_buffers():
            out[f"b{i}_{name}"] = b.clone()
    return out


def nan_step(mesh):
    """One GMFlow step whose target holds a NaN in rank 1's rows only:
    whether this rank skipped it, its step count, and how far its
    parameters moved."""
    cfg = gt.GMFlowTrainConfig(**GM)
    state = gt.init_state(cfg, seed=1, device="cpu", mesh=mesh)
    before = [p.detach().clone() for p in state.model.parameters()]
    b = {k: v.clone() for k, v in rows(batch(9), mesh).items()}
    if mesh.data_rank == 1:
        b["flow"][0, 0, 0, 0] = float("nan")
    state, m = gt.make_train_step(cfg, device="cpu", mesh=mesh)(state, b)
    moved = max(float((p - q).abs().max()) for p, q in
                zip(state.model.parameters(), before))
    return dict(skipped=m["skipped_nan"], step=torch.tensor(state.step),
                moved=torch.tensor(moved))


CASES = {
    # name: (world, model_parallel, what each process computes)
    "ring2": (2, 2, lambda mesh: ring_results(mesh.model_group)),
    "ring4": (4, 4, lambda mesh: ring_results(mesh.model_group)),
    "dp_gmflow": (2, 1, lambda mesh: run_steps(
        gt, gt.GMFlowTrainConfig(**GM), mesh, [3])),
    "dp_raft": (2, 1, lambda mesh: run_steps(
        rt, rt.RAFTTrainConfig(**RAFT), mesh, [4], gen_seed=5)),
    "mp_gmflow": (2, 2, lambda mesh: run_steps(
        gt, gt.GMFlowTrainConfig(model_parallel=2, **GM), mesh, [6, 7])),
    "dpmp_gmflow": (4, 2, lambda mesh: run_steps(
        gt, gt.GMFlowTrainConfig(model_parallel=2, **GM), mesh, [8])),
    "dp_nan": (2, 1, nan_step),
    "cli": (2, 1, None),
}


def cli_worker(out_dir: str, shard_dir: str) -> None:
    """``train.cli.main`` in this process, as ``torchrun`` would start it:
    2 RAFT-small steps of a batch of 4 on the ReDWeb shards."""
    from opticalflowfromdepth_torch.train import cli
    torch.set_num_threads(1)
    state = cli.main([
        "--model", "raft", "--small", "--batch_size", "4", "--image_size",
        "32", "48", "--iters", "2", "--no_mixed_precision", "--num_workers",
        "1", "--stage", "augmentedredweb", "--redweb_shards", shard_dir,
        "--num_steps", "2", "--save_latest_freq", "2", "--save_ckpt_freq",
        "2", "--log_dir", os.path.join(out_dir, "run"), "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    np.savez(os.path.join(out_dir, f"{os.environ['RANK']}.npz"),
             step=state.step, **{f"p{j}": p.detach().numpy() for j, p in
                                 enumerate(state.model.parameters())})


def worker(case: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    device = pm.init_distributed("cpu")
    assert device.type == "cpu" and torch.distributed.get_backend() == "gloo"
    world, mp, compute = CASES[case]
    mesh = pm.make_mesh(mp)
    assert mesh.world == world and mesh.model_parallel == mp
    res = compute(mesh)
    np.savez(os.path.join(out_dir, f"{mesh.rank}.npz"),
             data_rank=mesh.data_rank, data_world=mesh.data_world,
             model_rank=mesh.model_rank,
             **{k: v.detach().float().numpy() for k, v in res.items()})
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RUNS = {}


def _run(case, tmp_path_factory, *extra):
    """Every process of ``case`` (its output directory and ``extra`` as
    arguments), their rcs and their results (cached)."""
    if case in _RUNS:
        return _RUNS[case]
    world = CASES[case][0]
    out = str(tmp_path_factory.mktemp(case))
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, out, *extra],
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{case}: a process ran past {TIMEOUT} s")
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, (case, rcs, "\n".join(logs)[-4000:])
    res = [dict(np.load(os.path.join(out, f"{r}.npz"))) for r in range(world)]
    _RUNS[case] = res
    res[0]["out_dir"] = out
    return res


def _reference(compute, mesh):
    """``compute`` in this process with one thread (as the workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {k: v.detach().float().numpy()
                for k, v in compute(mesh).items()}
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ring2", "ring4"])
def test_ring_over_processes_matches_local_ring(case, tmp_path_factory):
    """Every rank returns the same output and the same whole gradients,
    and they are those of the same ring run in turn in one process
    (``LocalRing``), the steps being the same arithmetic on the same
    slices: 1e-6 (one thread on both sides: they agree to the bit here,
    the margin is for another BLAS's blocking)."""
    res = _run(case, tmp_path_factory)
    world = CASES[case][0]
    ref = _reference(lambda m: ring_results(seq.LocalRing(world)), None)
    for rank, got in enumerate(res):
        assert int(got["model_rank"]) == rank and int(got["data_world"]) == 1
        for k, want in ref.items():
            np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6,
                                       err_msg=f"{case} rank {rank} {k}")
    # and the ring against a dense softmax, forward and backward
    x = ring_inputs()
    q, k, v = (x[n].clone().requires_grad_() for n in "qkv")
    dense = torch.softmax(q @ k.transpose(1, 2) / 4.0, -1) @ v
    dense.backward(x["g"])
    for name, t in (("out", dense), ("dq", q.grad), ("dk", k.grad),
                    ("dv", v.grad)):
        np.testing.assert_allclose(res[0][name], t.detach().numpy(),
                                   rtol=0, atol=2e-6 * float(t.abs().max()))


def _check_steps(got, ref, steps, grad_tol, lr_sum, what):
    """Metrics 1e-5 relative (the rates 2 pixels of 3072 too: a pixel
    within rounding of a threshold may fall on the other side), the raw
    gradients within ``grad_tol`` of their global norm, parameters within
    two Adam updates at each step's learning rate (``lr_sum``: a gradient
    within rounding of 0 may take the other sign) and 99.5% of them within
    1e-6."""
    for i in range(steps):
        for k in (k for k in ref if k.startswith(f"m{i}_")):
            slack = 2 / (2 * H * W) if "px_" in k else 0.0
            assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]) + slack, (
                what, k, got[k], ref[k])
        gk = [k for k in ref if k.startswith(f"g{i}_")]
        norm = np.sqrt(sum(float((ref[k] ** 2).sum()) for k in gk))
        err = max(float(np.abs(got[k] - ref[k]).max()) for k in gk) / norm
        assert norm > 0 and err <= grad_tol, (what, i, err)
    pk = [k for k in ref if k.startswith(f"p{steps - 1}_")]
    d = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in pk])
    assert d.max() <= 2 * lr_sum, (what, d.max())
    assert (d <= 1e-6).mean() >= 0.995, (what, (d <= 1e-6).mean())


def _lr_sum(cfg, steps):
    from opticalflowfromdepth_torch.train.optim import one_cycle_schedule
    sched = one_cycle_schedule(cfg.lr, cfg.num_steps + 100,
                               anneal_strategy="cos" if isinstance(
                                   cfg, gt.GMFlowTrainConfig) else "linear")
    return sum(sched(i) for i in range(steps))


@pytest.mark.parametrize("case", ["dp_gmflow", "dp_raft"])
def test_data_parallel_step_matches_whole_batch(case, tmp_path_factory):
    """Two processes, each stepping on its half of the batch, against the
    single-process step on the whole batch: both ranks hold the same
    parameters (bit for bit), and the metrics, gradients and parameters
    of ``_check_steps`` (gradients 2e-5 of their norm: the mean of two
    halves' means in f32 against one mean). RAFT-basic's batch norm takes
    the whole batch's statistics (its running statistics 1e-5) and each
    rank adds its rows of the whole batch's noise."""
    res = _run(case, tmp_path_factory)
    world, mp, compute = CASES[case]
    assert [int(r["data_rank"]) for r in res] == [0, 1]
    for k in res[0]:
        if k[0] == "p":
            assert np.array_equal(res[0][k], res[1][k]), k
    ref = _reference(compute, pm.ProcessMesh())
    cfg = gt.GMFlowTrainConfig(**GM) if case == "dp_gmflow" \
        else rt.RAFTTrainConfig(**RAFT)
    _check_steps(res[0], ref, 1, 2e-5, _lr_sum(cfg, 1), case)
    buffers = [k for k in ref if k.startswith("b0_")]
    assert bool(buffers) == (case == "dp_raft")
    for k in buffers:
        np.testing.assert_allclose(res[0][k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_nan_skip_is_decided_for_every_rank(tmp_path_factory):
    """A NaN in one rank's half of the batch skips the step on both ranks
    (the whole batch's loss decides), so the replicas stay the same."""
    res = _run("dp_nan", tmp_path_factory)
    for r in res:
        assert (float(r["skipped"]), int(r["step"]), float(r["moved"])) == (
            1.0, 0, 0.0)


def test_dropout_with_data_parallelism_raises():
    """Each rank would draw its own dropout mask, not its rows of the
    whole batch's: refused rather than computed otherwise than JAX."""
    with pytest.raises(ValueError, match="dropout"):
        rt.build_model(rt.RAFTTrainConfig(dropout=0.1),
                       mesh=pm.ProcessMesh(data_world=2))
    rt.build_model(rt.RAFTTrainConfig(dropout=0.1, small=True),
                   mesh=pm.ProcessMesh())


def test_model_parallel_steps_match_unsharded(tmp_path_factory):
    """Two GMFlow steps over a model group of two processes (data world
    1: both read the whole batch), against the unsharded single-process
    steps: both ranks the same parameters bit for bit, and
    ``_check_steps`` (gradients 1e-5 of their norm) over both steps."""
    res = _run("mp_gmflow", tmp_path_factory)
    assert [int(r["model_rank"]) for r in res] == [0, 1]
    assert all(int(r["data_world"]) == 1 for r in res)
    for k in res[0]:
        if k[0] == "p":
            assert np.array_equal(res[0][k], res[1][k]), k
    ref = _reference(lambda m: run_steps(gt, gt.GMFlowTrainConfig(**GM), m,
                                         [6, 7]), pm.ProcessMesh())
    _check_steps(res[0], ref, 2, 1e-5, _lr_sum(gt.GMFlowTrainConfig(**GM), 2),
                 "mp_gmflow")


def test_data_and_model_parallel_mesh(tmp_path_factory):
    """Four processes as 2 data x 2 model ranks (model groups {0, 1} and
    {2, 3}): each model group reads its half of the batch; every rank ends
    with the same parameters, which are the single-process unsharded
    step's on the whole batch (``_check_steps``, gradients 2e-5)."""
    res = _run("dpmp_gmflow", tmp_path_factory)
    assert [(int(r["data_rank"]), int(r["model_rank"])) for r in res] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res[1:]:
        for k in res[0]:
            if k[0] == "p":
                assert np.array_equal(res[0][k], r[k]), k
    ref = _reference(lambda m: run_steps(gt, gt.GMFlowTrainConfig(**GM), m,
                                         [8]), pm.ProcessMesh())
    _check_steps(res[0], ref, 1, 2e-5, _lr_sum(gt.GMFlowTrainConfig(**GM), 1),
                 "dpmp_gmflow")


def test_training_cli_in_two_processes(tmp_path_factory):
    """``train.cli.main`` in two processes joins the group from the
    environment, splits the batch of 4 by data rank, keeps both ranks'
    parameters the same bit for bit, writes the checkpoints once (rank 0)
    and leaves the group."""
    from opticalflowfromdepth_torch.tools.convergence_smoke import \
        synthesize_shards
    shard_dir = str(tmp_path_factory.mktemp("cli_shards"))
    synthesize_shards(shard_dir, 2, 64, 96, seed=0, device="cpu")
    res = _run("cli", tmp_path_factory, shard_dir)
    assert [int(r["step"]) for r in res] == [2, 2]
    for k in res[1]:
        if k[0] == "p":
            assert np.array_equal(res[0][k], res[1][k]), k
    ckpts = os.path.join(res[0]["out_dir"], "run", "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["latest.pth", "step_2_weights.pth"]


def test_init_distributed_without_the_environment_is_a_no_op(monkeypatch):
    for k in pm.ENV:
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert pm.make_mesh() == pm.ProcessMesh()


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        cli_worker(sys.argv[2], sys.argv[3])
    else:
        worker(sys.argv[1], sys.argv[2])
