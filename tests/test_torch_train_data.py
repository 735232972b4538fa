"""The trainers' host data path of the port (data/collate.py,
data/loader.py, utils/meters.py) against the JAX package's on the CPU.

Collated arrays are bitwise equal to the JAX package's. The loader's
thread and process modes yield the same batches in the same order; nothing
is asserted about worker processes or scheduling."""

import functools

import numpy as np
import pytest
import torch

from canonicalvoting_tpu.data import collate as jcollate
from canonicalvoting_tpu.utils.meters import AverageMeter as JaxMeter

from canonicalvoting_tpu_torch.data import collate as tcollate
from canonicalvoting_tpu_torch.data.loader import DataLoader, ListDataset
from canonicalvoting_tpu_torch.ops.coords import PyramidSpec, build_pyramid
from canonicalvoting_tpu_torch.ops.voxelize import batched_coordinates
from canonicalvoting_tpu_torch.utils.meters import AverageMeter

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import joint_items, separate_items

PYRAMID_KEYS = ("nbr_stem", "nbr_conv", "nbr_down", "nbr_up")


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _same_batch(got, want):
    """A port host batch against a JAX one, array for array."""
    pyr, jp = got["pyramid"], want["pyramid"]
    _equal(pyr.nbr_stem, jp["nbr_stem"], "nbr_stem")
    for k in PYRAMID_KEYS[1:]:
        assert len(getattr(pyr, k)) == len(jp[k]), k
        for i, (a, b) in enumerate(zip(getattr(pyr, k), jp[k])):
            _equal(a, b, (k, i))
    assert tuple(pyr.nvalid) == tuple(int(v) for v in jp["nvalid"])
    _equal(got["meta"]["coords"], want["meta"]["coords"], "coords")
    assert got["meta"]["ids"] == want["meta"]["ids"]
    keys = set(want) - {"pyramid", "meta"}
    assert set(got) - {"pyramid", "meta"} == keys
    for k in keys:
        _equal(got[k], want[k], k)


@pytest.fixture(scope="module")
def items():
    rng = np.random.RandomState(0)
    return {"joint": joint_items(rng, n=4), "separate": separate_items(rng, n=4)}


@pytest.mark.parametrize("microbatch", [0, 1, 2])
@pytest.mark.parametrize("kind", ["joint", "separate"])
def test_collate_bitwise_equals_jax(items, kind, microbatch):
    """Whole batches and microbatches of 1 and 2 scenes with pinned
    capacities; the separate batch's batch-global object ids, symmetry
    codes and the objects past max_objects (dropped)."""
    its = items[kind]
    if kind == "joint":
        got = tcollate.collate_joint(its, cap_multiple=256, microbatch=microbatch)
        want = jcollate.collate_joint(its, cap_multiple=256, microbatch=microbatch)
    else:
        kw = dict(cap_multiple=256, max_objects=5, microbatch=microbatch)
        got = tcollate.collate_separate(its, **kw)
        want = jcollate.collate_separate(its, **kw)
    if not microbatch:
        _same_batch(got, want)
        return
    assert got["meta"] == want["meta"]
    assert len(got["microbatches"]) == len(want["microbatches"]) == 4 // microbatch
    for g, w in zip(got["microbatches"], want["microbatches"]):
        _same_batch(g, w)
        assert [t.shape for t in g["pyramid"].tables()] == [
            t.shape for t in got["microbatches"][0]["pyramid"].tables()]
    if kind == "separate" and microbatch == 2:
        # the batch-global ids restart a microbatch; 4 objects, none dropped
        assert int(got["microbatches"][0]["num_objects"]) == 4


def test_pin_capacities_equals_a_pyramid_built_at_them(items):
    coords = batched_coordinates([it[1] for it in items["joint"][:2]])
    pyr = build_pyramid(coords, PyramidSpec(cap_multiple=64))
    caps = [c.shape[0] + 100 + 7 * i for i, c in enumerate(pyr.coords)]
    want = build_pyramid(coords, PyramidSpec(capacities=tuple(caps)))
    got = tcollate.pin_capacities(pyr, caps)
    for a, b in zip(got.coords + got.tables(), want.coords + want.tables()):
        _equal(a, b, "pinned pyramid")
    assert got.nvalid == want.nvalid


def test_upload_batch_puts_every_array_on_the_device(items):
    batch = tcollate.collate_separate(items["separate"], cap_multiple=256,
                                      max_objects=8)
    up = tcollate.upload_batch(batch, "cpu")
    for k in ("feats", "base_xyz", "scale_labels", "obj_labels", "class_labels",
              "obj_id", "sym_code"):
        assert torch.is_tensor(up[k]) and np.array_equal(up[k].numpy(), batch[k])
    assert up["num_objects"] == batch["num_objects"]
    assert up["pyramid"]["nvalid"] == tuple(batch["pyramid"].nvalid)
    assert np.array_equal(up["pyramid"]["nbr_stem"].numpy(),
                          batch["pyramid"].nbr_stem)


def _batches(loader):
    return [b for b in loader]


def test_loader_thread_and_process_modes_yield_the_same_batches(items):
    """Shuffled, last partial batch dropped, two epochs (the process pool is
    reused across epochs, the order follows the seed in both modes)."""
    ds = ListDataset(items["joint"] + items["joint"][:1])
    collate = functools.partial(tcollate.collate_joint, cap_multiple=256)
    out = {}
    for mode in ("thread", "process"):
        loader = DataLoader(ds, batch_size=2, collate_fn=collate, shuffle=True,
                            num_workers=2, drop_last=True, seed=3,
                            workers_mode=mode)
        try:
            out[mode] = [_batches(loader), _batches(loader)]
        finally:
            loader.close()
    assert len(loader) == 2
    for e in range(2):
        assert len(out["thread"][e]) == len(out["process"][e]) == 2
        for a, b in zip(out["thread"][e], out["process"][e]):
            assert a["meta"]["ids"] == b["meta"]["ids"]
            for x, y in zip(a["pyramid"].tables(), b["pyramid"].tables()):
                _equal(x, y, "tables")
            _equal(a["feats"], b["feats"], "feats")
    assert [b["meta"]["ids"] for b in out["thread"][0]] != \
        [b["meta"]["ids"] for b in out["thread"][1]]


def test_loader_order_equals_the_jax_loader():
    from canonicalvoting_tpu.data.loader import DataLoader as JaxLoader

    ds = ListDataset(list(range(7)))
    kw = dict(batch_size=3, collate_fn=list, shuffle=True, num_workers=1, seed=5)
    for drop_last in (False, True):
        ours = DataLoader(ds, drop_last=drop_last, **kw)
        theirs = JaxLoader(ds, drop_last=drop_last, workers_mode="thread", **kw)
        assert len(ours) == len(theirs)
        for _ in range(2):
            assert _batches(ours) == _batches(theirs)


def test_loader_raises_a_worker_error_and_refuses_unpicklable_work():
    def bad(batch):
        raise KeyError("collate failed")

    loader = DataLoader(ListDataset([1, 2]), batch_size=1, collate_fn=bad,
                        num_workers=1)
    with pytest.raises(KeyError, match="collate failed"):
        _batches(loader)
    loader = DataLoader(ListDataset([1, 2]), batch_size=1,
                        collate_fn=lambda b: b, num_workers=2)
    with pytest.raises(TypeError, match="picklable"):
        _batches(loader)


def test_average_meter_matches_jax():
    ours, theirs = AverageMeter(), JaxMeter()
    for v, n in ((1.5, 1), (2.0, 3), (-0.5, 2)):
        ours.update(v, n)
        theirs.update(v, n)
    assert vars(ours) == vars(theirs)
    ours.reset()
    assert ours.count == 0 and ours.avg == 0.0
