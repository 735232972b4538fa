"""Mesh training of the port (parallel/data_parallel.py, the sharded
collates, sync-BN, the column-parallel convs, the loops' and CLIs' mesh
branches) on four gloo CPU ranks, against the JAX package's
make_dp_train_step / make_dp_train_step_separate on the conftest's
virtual CPU devices, at the narrow plan and float32 of
tests/test_parallel.py:116-152.

One spawn of four ranks (parallel/launch.py:run_ranks, rank side in
tests/torch_mesh_ranks.py, which imports the port only) runs every
rank-side case once for the module while processes of their own run the
JAX references. A 2 x 2 and a 2 x 1 mesh compute one function (two shards of
two scenes each, sync-BN over both): both are held to JAX's 2 x 2 step; a
1 x 2 mesh (one shard of the four scenes) to JAX's 1 x 2 step.

Tolerances are the train-step tests' (tests/test_torch_train_step.py,
float32): losses within 1e-5 relative; each gradient (read from the first
Adam moment), moment and running statistic within 1e-4 of its tensor's
peak; updated parameters within lr x 1e-3 wherever |g| > 1e-6. The column
gather's backward and sync-BN are held to one rank at 1e-5 of each
output's peak (float32 sums in another order)."""

import functools
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.config import Config as JConfig
from canonicalvoting_tpu.data import collate as jcollate
from canonicalvoting_tpu.models.minkunet import MinkUNetBase as JaxMinkUNet
from canonicalvoting_tpu.parallel import data_parallel as jdp
from canonicalvoting_tpu.parallel.mesh import make_mesh as jax_make_mesh
from canonicalvoting_tpu.train import checkpoint as jckpt
from canonicalvoting_tpu.train import steps as jsteps

from canonicalvoting_tpu_torch.config import load_config
from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.data.loader import ListDataset
from canonicalvoting_tpu_torch.models.norm import MaskedBatchNorm
from canonicalvoting_tpu_torch.parallel.data_parallel import split_kernels
from canonicalvoting_tpu_torch.parallel.launch import run_ranks
from canonicalvoting_tpu_torch.train import joint_loop
from canonicalvoting_tpu_torch.utils.weights import flatten

from tests import torch_mesh_ranks as R
from tests.test_torch_dense_unet import (  # noqa: F401  (autouse fixture)
    one_torch_thread, randomize, variables_of)
from tests.test_torch_train_step import joint_items, separate_items

B1 = 0.9
KINDS = ("joint", "separate")


def _peak_rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


class Case:
    """The module's inputs (numpy, from seeds)."""

    def __init__(self, root):
        self.root = root
        self.joint = joint_items(np.random.RandomState(0))
        self.separate = separate_items(np.random.RandomState(0))
        self.variables = {
            kind: randomize(variables_of(R.narrow(3, R.JOINT_OUT if kind == "joint"
                                                  else 8)),
                            np.random.RandomState(3))
            for kind in KINDS}
        rng = np.random.RandomState(5)
        self.bn_rows = []
        for n, pad in ((37, 11), (52, 12)):
            x = rng.randn(n + pad, 6).astype(np.float32)
            x[n:] = 1e3  # junk padding rows, which no loss reads
            g = rng.randn(n + pad, 6).astype(np.float32)
            g[n:] = 0.0
            self.bn_rows.append((x, n, g))
        self.bn_scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
        nbr = rng.randint(-1, 50, (60, 27)).astype(np.int32)
        self.conv = (rng.randn(50, 12).astype(np.float32), nbr,
                     (rng.randn(27, 12, 16) * 0.2).astype(np.float32),
                     rng.randn(60, 16).astype(np.float32))

    def job(self):
        return {"variables": {k: (v["params"], v["batch_stats"])
                              for k, v in self.variables.items()},
                "joint": self.joint, "separate": self.separate,
                "bn_rows": self.bn_rows, "bn_scale": self.bn_scale,
                "conv": self.conv, "root": os.path.join(self.root, "loops")}


def _jax_step(c, kind, data, model):
    """JAX's mesh step on the module's global batch: (params, running
    statistics, Adam moments (mu, nu), losses), as numpy trees. It runs in
    a process of its own: JAX's tracing holds the GIL, so four references
    in threads take as long as four in a row."""
    variables = c.variables[kind]
    mesh = jax_make_mesh(data, model)
    opt = jsteps.make_optimizer(0.0)
    state = jdp.shard_train_state(jsteps.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=opt.init(variables["params"]),
        step=jnp.zeros((), jnp.int32)), mesh)
    net = JaxMinkUNet(3, R.JOINT_OUT if kind == "joint" else 8, bn_axis="batch",
                      **R.TINY)
    if kind == "joint":
        batch = jcollate.collate_joint_sharded(c.joint, data, cap_multiple=256)
        step = jdp.make_dp_train_step(net, opt, JConfig(), mesh)
    else:
        batch = jcollate.collate_separate_sharded(
            c.separate, data, cap_multiple=256, max_objects=R.MAX_OBJECTS)
        step = jdp.make_dp_train_step_separate(net, opt, JConfig(), mesh,
                                               R.MAX_OBJECTS)
    st, losses = jax.device_get(step(state, batch, jnp.float32(R.LR),
                                     jnp.float32(R.MOM)))
    inner = st.opt_state.inner_state[0]
    return {"params": st.params, "batch_stats": st.batch_stats,
            "mu": inner.mu, "nu": inner.nu, "step": int(st.step),
            "losses": {k: float(v) for k, v in losses.items()}}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_train"))
    c = Case(root)
    keys = [(kind, data) for kind in KINDS for data in (2, 1)]
    with ThreadPoolExecutor(1) as thread, ProcessPoolExecutor(
            len(keys), mp_context=multiprocessing.get_context("spawn")) as procs:
        ranks = thread.submit(run_ranks, [functools.partial(R.rank_main, c.job())],
                              4, os.path.join(root, "ranks"))
        jax_runs = [procs.submit(_jax_step, c, kind, data, 2)
                    for kind, data in keys]
        c.jax = {k: r.result() for k, r in zip(keys, jax_runs)}
        c.ranks = [r[0] for r in ranks.result()]
    return c


def _jax_moments(jst):
    mu, nu = dict(flatten(jst["mu"])), dict(flatten(jst["nu"]))
    return {k: (np.asarray(mu[k]) / (1 - B1), np.asarray(mu[k]), np.asarray(nu[k]))
            for k in mu}


STEPS = [(kind, data, model) for data, model in R.MESHES for kind in KINDS]


def _ids(p):
    return f"{p[0]}-{p[1]}x{p[2]}"


@pytest.mark.parametrize("key", STEPS, ids=_ids)
def test_mesh_step_matches_jax(case, key):
    """Losses, gradients, Adam moments, running statistics and updated
    parameters of the port's gathered state against JAX's mesh step."""
    kind, data, model = key
    jst = case.jax[(kind, data)]
    jlosses = jst["losses"]
    r = case.ranks[0]["steps"][key]
    assert r["step"] == 1
    for k, v in jlosses.items():
        np.testing.assert_allclose(r["losses"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    jm = _jax_moments(jst)
    assert set(r["moments"]) == set(jm)
    for n, (g, mu, nu) in jm.items():
        got_mu, got_nu = r["moments"][n]
        assert _peak_rel(got_mu / (1 - B1), g) <= 1e-4, (n, "grad")
        assert _peak_rel(got_mu, mu) <= 1e-4, (n, "mu")
        assert _peak_rel(got_nu, nu) <= 1e-4, (n, "nu")
    assert jst["step"] == 1
    stats = {k: np.asarray(v) for k, v in flatten(jst["batch_stats"])}
    params = {k: np.asarray(v) for k, v in flatten(jst["params"])}
    before = dict(flatten(case.variables[kind]["batch_stats"]))
    for n, want in stats.items():
        assert not np.array_equal(want, before[n]), n
        assert _peak_rel(r["full"][n], want) <= 1e-4, n
    for n, want in params.items():
        d = np.abs(r["full"][n] - want)
        sel = np.abs(jm[n][0]) > 1e-6
        assert (d[sel] <= R.LR * 1e-3).all(), (n, float(d[sel].max()))
        assert (d <= 2 * R.LR).all(), n


@pytest.mark.parametrize("key", STEPS, ids=_ids)
def test_mesh_ranks_agree(case, key):
    """Every rank gathers the same state; the running statistics are equal
    across the data ranks and the replicated parameters across the model
    ranks (no model-group reduction needed), bit for bit; the split
    kernels are JAX's param_shardings (every conv, Cout even)."""
    kind, data, model = key
    rs = [r["steps"][key] for r in case.ranks if key in r["steps"]]
    assert len(rs) == data * model
    for r in rs[1:]:
        for n, v in rs[0]["full"].items():
            assert np.array_equal(r["full"][n], v), n
    split = {f"{m}.kernel" for m in rs[0]["split"]}
    n_convs = sum(1 for n in rs[0]["full"] if n.endswith("kernel"))
    assert len(split) == (n_convs if model > 1 else 0)
    for a in rs:
        for b in rs:
            same_m = a["coords"][1] == b["coords"][1]
            same_d = a["coords"][0] == b["coords"][0]
            for n, v in a["own"].items():
                stat = n.endswith((".mean", ".var"))
                if (stat and same_m) or (same_d and n not in split):
                    assert np.array_equal(v, b["own"][n]), (n, a["coords"],
                                                            b["coords"])


def test_sync_bn_matches_one_norm_over_the_rows(case):
    """Sync-BN on two ranks against one norm over both ranks' valid rows:
    outputs, input gradients, the parameters' gradients summed over the
    ranks (as the step's all-reduce sums them), running statistics."""
    got = [r["sync_bn"] for r in case.ranks[:2]]
    x = np.concatenate([x[:n] for x, n, _ in case.bn_rows])
    g = np.concatenate([g[:n] for _, n, g in case.bn_rows])
    norm = MaskedBatchNorm(x.shape[1])
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(case.bn_scale))
    xt = torch.from_numpy(x).requires_grad_()
    y = norm(xt, len(x), True, 0.3)
    (y * torch.from_numpy(g)).sum().backward()
    ns = [n for _, n, _ in case.bn_rows]
    for name, want in (("y", y), ("dx", xt.grad)):
        want = want.detach().numpy()
        parts = np.concatenate([r[name][:n] for r, n in zip(got, ns)])
        assert _peak_rel(parts, want) <= 1e-5, name
    for name, want in (("dscale", norm.scale.grad), ("dbias", norm.bias.grad)):
        assert _peak_rel(got[0][name] + got[1][name], want.numpy()) <= 1e-5, name
    for name in ("mean", "var"):
        assert np.array_equal(got[0][name], got[1][name])
        assert _peak_rel(got[0][name], getattr(norm, name).numpy()) <= 1e-5


def test_column_gather_backward_matches_one_rank(case):
    """A conv split over two model ranks: output, input gradient and the
    gathered kernel gradient equal the whole conv's (model=1); an
    all-gather whose backward summed the slices would double the kernel
    gradient, and one whose input gradient took the rank's columns only
    would miss the other rank's."""
    for r in case.ranks[:2]:
        got, want = r["column_conv"]["split"], r["column_conv"]["whole"]
        for name in ("y", "dx", "dw"):
            assert _peak_rel(got[name], want[name]) <= 1e-5, name


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_collate_equals_jax_shards(case, kind):
    """Each shard, pinned to the shards' largest capacities, bit for bit
    the JAX package's shard of the same index."""
    items = case.joint if kind == "joint" else case.separate
    for n_shards in (2, 1):
        if kind == "joint":
            want = jcollate.collate_joint_sharded(items, n_shards, cap_multiple=256)
            shards = [tcollate.collate_joint_sharded(items, n_shards, s, 256)
                      for s in range(n_shards)]
        else:
            want = jcollate.collate_separate_sharded(
                items, n_shards, cap_multiple=256, max_objects=R.MAX_OBJECTS)
            shards = [tcollate.collate_separate_sharded(
                items, n_shards, s, 256, R.MAX_OBJECTS) for s in range(n_shards)]
        caps = np.max([tcollate.shard_capacities(s) for s in shards], 0)
        for s, shard in enumerate(shards):
            got = tcollate.pin_shard(shard, caps)
            assert got["meta"]["ids"] == want["meta"]["ids"][s]
            pyr = got.pop("pyramid")
            for name in ("nbr_stem", "nbr_conv", "nbr_down", "nbr_up", "nvalid"):
                w = want["pyramid"][name]
                a = getattr(pyr, name)
                if isinstance(w, tuple):
                    assert len(a) == len(w), name
                    for x, y in zip(a, w):
                        assert np.array_equal(np.asarray(x), y[s]), name
                else:
                    assert np.array_equal(a, w[s]), name
            for name, v in got.items():
                if name != "meta":
                    assert v.dtype == want[name].dtype and np.array_equal(
                        v, want[name][s]), name


def test_mesh_loops_and_clis_train_checkpoint_and_validate(case, tmp_path):
    """The joint loop and both CLIs (the separate loop under its CLI) at
    2 x 2 over four ranks: epoch 0, one step, a validation whose result
    every rank gets; rank 0 alone writes the checkpoint and the metrics
    files; a second call resumes on every rank from the full checkpoint
    and trains epoch 1; a mesh that is not the world is refused. Epoch 1's
    checkpoint restores in JAX's restore_checkpoint and in the port's
    single-process loop."""
    loops = [r["loops"] for r in case.ranks]
    for name in ("joint", "cli_joint"):
        assert all(lp[name]["step"] == 1 for lp in loops)
        rets = [lp[name]["ret"] for lp in loops]
        assert set(rets[0]) == {0.25, 0.5} and all(r == rets[0] for r in rets)
    for lp in loops:
        ((st, ret),) = lp["cli_separate"].values()
        assert st == 1 and set(ret) == {0.25, 0.5}
        assert "mesh of tpu.mesh_data x tpu.mesh_model = 2" in lp["refused"]
    assert loops[0]["joint"]["history"][0]["scenes"] == 4
    # the second call resumed from epoch 0's checkpoint on every rank
    assert all(lp["resumed"] == {"step": 2, "epochs": [1]} for lp in loops)
    assert loops[0]["files"]["joint"] == [
        "epoch0.ckpt", "epoch1.ckpt", "train.csv", "train.jsonl",
        "val_iou0.25.csv", "val_iou0.25.jsonl", "val_iou0.5.csv",
        "val_iou0.5.jsonl"]
    path = os.path.join(case.root, "loops", "joint", "epoch1.ckpt")
    variables = case.variables["joint"]
    opt = jsteps.make_optimizer(0.0)
    template = jsteps.TrainState(params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 opt_state=opt.init(variables["params"]),
                                 step=jnp.zeros((), jnp.int32))
    jstate, epoch = jckpt.restore_checkpoint(path, template)
    assert epoch == 1 and int(jstate.step) == 2
    # the port's single-process loop resumes it (nothing left to train)
    workdir = str(tmp_path / "single")
    shutil.copytree(os.path.dirname(path), workdir)
    cfg = load_config(None, ["batch_size=2", "num_workers=0", "max_epoch=1",
                             "tpu.conv_dtype=float32"])
    state, ret = joint_loop.run_joint_training(
        cfg, ListDataset(case.joint), ListDataset(case.joint[:1]),
        workdir=workdir, gt_lookup=lambda _id: [], eval_every=1,
        cap_multiple=256, model=R.narrow(3, R.JOINT_OUT), device="cpu")
    assert ret is None and state.step == 2
    sd = state.model.state_dict()
    for n, v in list(flatten(jstate.params)) + list(flatten(jstate.batch_stats)):
        assert np.array_equal(sd[n].numpy(), np.asarray(v)), n
    assert split_kernels(state.model, 2)  # the narrow plan has split convs


def test_ranks_import_no_jax(case):
    for r in case.ranks:
        bad = [m for m in r["modules"] if m.split(".")[0] in
               ("jax", "jaxlib", "flax", "optax", "canonicalvoting_tpu")]
        assert not bad and "canonicalvoting_tpu_torch.parallel.data_parallel" \
            in r["modules"]
