"""Float32 grids through the occupied-row kernels (ops/tiled_conv.py, rows
1-3, 6 and 7 at conv_dtype=float32), on the CPU.

- Each CUDA wrapper's dtype dispatch with the ctypes launcher and the CUDA
  stream stubbed, on CPU tensors that report themselves as CUDA ones (so
  they take the card's route up to the launch): a float32 grid
  reaches the ``<name>_f32_launch`` symbol with its argument list, a
  bfloat16 grid the ``<name>_launch`` one, each counted on its own counter
  (``launches_f32``, ``launches``), every argument of the ctypes type its
  signature names; float16 and float64 grids raise. The fused block (row 9)
  dispatches the same way, and its float32 call takes the K splits of the
  model's two float32 convs.
- Both CLIs with tpu.conv_dtype=float32: every conv of the backbones gets
  float32 grids, and the detections equal the pipelines' on the same item
  (the tails decode planted rows; the backbones' rows are held bitwise)."""

import numpy as np
import pytest
import torch

import canonicalvoting_tpu_torch.models.dense_unet as du
import canonicalvoting_tpu_torch.ops.tiled_conv as tc
from canonicalvoting_tpu_torch import eval_joint, eval_separate
from canonicalvoting_tpu_torch.config import load_config
from canonicalvoting_tpu_torch.data.dense_prep import MX, MY, MZ
from canonicalvoting_tpu_torch.data.scannet import ScanNetXYZProbMultiDataset
from canonicalvoting_tpu_torch.data.synthetic_tree import write_scannet_tree
from canonicalvoting_tpu_torch.decode.peeling import PeelConfig
from canonicalvoting_tpu_torch.eval.pipeline import DetectionPipeline
from canonicalvoting_tpu_torch.eval.separate import (
    ALL_CATEGORIES, SeparateDetectionPipeline)
from canonicalvoting_tpu_torch.utils.weights import category_state_dicts

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401
from tests.test_torch_eval_cli import (  # noqa: F401  (fixtures)
    ARGS, RES, SEPARATE_KW, assert_same_detections, captured, narrow,
    narrow_unet, planted, scene)

DIMS = (8, 8, 32)  # interior of the fine grid; coarse (4, 4, 16)
# kernel calls of a pass of the narrow net (one block a stage)
PER_PASS = 1 + 2 * 8 + 4 + 4


def _grid(dims, c, dtype):
    return torch.empty(dims[0] + 2 * MX, dims[1] + 2 * MY, dims[2] + 2 * MZ, c,
                       dtype=dtype, device="cpu")


def _occ(dims):
    return torch.empty(dims[0] + 2 * MX, dims[1] + 2 * MY, dims[2] + 2 * MZ,
                       device="cpu")


def _tiles(n=2):
    return torch.empty(n, 3, dtype=torch.int32, device="cpu")


def _calls(dtype):
    """(wrapper, call) of the five float32 rows' wrappers on empty grids."""
    coarse = tuple(d // 2 for d in DIMS)
    ch = lambda n: torch.ones(n, device="cpu")  # noqa: E731
    fine8, fine3, fine80 = (_grid(DIMS, c, dtype) for c in (8, 3, 80))
    return [
        (tc.tiled_conv3d, lambda: tc.tiled_conv3d(
            fine8, torch.empty(27, 8, 16), _tiles(), tile_shape=(4, 4, 8),
            kernel_size=3, scale=ch(16), bias=ch(16), occ=_occ(DIMS),
            residual=_grid(DIMS, 4, dtype), res_w=torch.empty(4, 16),
            relu_out=True)),
        (tc.tiled_conv3d, lambda: tc.tiled_conv3d(
            fine3, torch.empty(125, 3, 8), _tiles(), tile_shape=(4, 4, 8),
            kernel_size=5, occ=_occ(DIMS))),
        (tc.tiled_conv3d_prefolded, lambda: tc.tiled_conv3d_prefolded(
            fine80, torch.empty(125, 3, 8), _tiles(), tile_shape=(4, 4, 8),
            kernel_size=5, scale=ch(8), bias=ch(8), occ=_occ(DIMS),
            relu_out=True)),
        (tc.tiled_down2, lambda: tc.tiled_down2(
            fine8, torch.empty(8, 8, 8), _tiles(), tile_shape=(2, 2, 8),
            occ=_occ(coarse), relu_out=True)),
        (tc.tiled_up2, lambda: tc.tiled_up2(
            _grid(coarse, 8, dtype), torch.empty(8, 8, 16), _tiles(),
            tile_shape=(4, 4, 8), occ=_occ(DIMS), skip=fine8, skip_c=8)),
        (tc.tiled_up2_into, lambda: tc.tiled_up2_into(
            _grid(coarse, 8, dtype), torch.empty(8, 8, 16), _tiles(),
            dest=_grid(DIMS, 24, dtype), skip_c=8, tile_shape=(4, 4, 8),
            occ=_occ(DIMS))),
    ]


class Launches(list):
    """The launch symbols called; ``args``, their argument lists."""

    def __init__(self):
        super().__init__()
        self.args = []


@pytest.fixture
def launched(monkeypatch):
    """The launch symbols called, with their argument counts and types
    checked against the ctypes signatures (a pointer: an int or None; an
    int: an int)."""
    names = Launches()

    def launcher(name):
        def launch(*args):
            types = tc._ARGTYPES[name]
            assert len(args) == len(types), name
            for i, (a, t) in enumerate(zip(args, types)):
                ok = a is None or type(a) is int if t is tc._P else type(a) is int
                assert ok, (name, i, a)
            names.append(name)
            names.args.append(args)
            return 0
        return launch

    monkeypatch.setattr(tc, "_launcher", launcher)
    monkeypatch.setattr(tc, "_stream", lambda: 0)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for fn, _ in _calls(torch.float32):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_f32", 0)
    monkeypatch.setattr(tc.tiled_block3d, "launches", 0)
    monkeypatch.setattr(tc.tiled_block3d, "launches_f32", 0)
    return names


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "_f32"),
                                          (torch.bfloat16, "")])
def test_card_route_dispatches_on_the_grid_dtype(launched, dtype, suffix):
    calls = _calls(dtype)
    for fn, call in calls:
        out = call()
        assert out.dtype == dtype
    want = ["tiled_conv3d", "tiled_conv3d", "tiled_conv3d_prefolded",
            "tiled_down2", "tiled_up2", "tiled_up2_into"]
    assert launched == [f"{n}{suffix}_launch" for n in want]
    counted, other = ("launches_f32", "launches") if suffix else (
        "launches", "launches_f32")
    for fn in {fn for fn, _ in calls}:
        assert getattr(fn, counted) == want.count(fn.__name__)
        assert getattr(fn, other) == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_card_route_refuses_other_dtypes(launched, dtype):
    for _, call in _calls(dtype):
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            call()
    assert launched == []


def test_fused_block_dispatches_on_the_grid_dtype(launched):
    """Row 9's card route: a float32 grid reaches tiled_block3d_f32_launch,
    a bfloat16 grid tiled_block3d_launch, each counted apart. A float32
    block with the fused 1x1 over enough listed rows that the split scratch
    caps its splits (s_max1 2, s_max2 1) passes the s_max that the model's
    two float32 tiled_conv3d calls pass, so the card sums in their order."""
    ch = {k: torch.ones(8, device="cpu") for k in ("scale1", "bias1", "scale2", "bias2")}
    kw = dict(tile_shape=(4, 4, 8), occ=_occ(DIMS), **ch)
    w = torch.empty(27, 8, 8)
    for dtype in (torch.float32, torch.bfloat16):
        assert tc.tiled_block3d(_grid(DIMS, 8, dtype), w, w, _tiles(),
                                **kw).dtype == dtype
    assert launched == ["tiled_block3d_f32_launch", "tiled_block3d_launch"]
    assert (tc.tiled_block3d.launches_f32, tc.tiled_block3d.launches) == (1, 1)

    x, w1, rw = _grid(DIMS, 12, torch.float32), torch.empty(27, 12, 8), torch.empty(12, 8)
    tiles = _tiles(12000)  # 1,536,000 listed rows
    res = dict(res_w=rw, res_scale=torch.ones(8), res_bias=torch.ones(8))
    tc.tiled_block3d(x, w1, w, tiles, **kw, **res)
    conv = dict(tile_shape=(4, 4, 8), kernel_size=3, occ=kw["occ"], relu_out=True)
    tc.tiled_conv3d(x, w1, tiles, scale=ch["scale1"], bias=ch["bias1"], **conv)
    tc.tiled_conv3d(_grid(DIMS, 8, torch.float32), w, tiles, scale=ch["scale2"],
                    bias=ch["bias2"], residual=x, **res, **conv)
    assert launched[2:] == ["tiled_block3d_f32_launch"] + 2 * ["tiled_conv3d_f32_launch"]
    block, conv1, conv2 = launched.args[2:]
    assert block[-3:-1] == (2, 1)
    assert block[-3:-1] == (conv1[-2], conv2[-2])


@pytest.fixture
def conv_dtypes(monkeypatch):
    """The grid dtype of every kernel call the dense backbone makes."""
    seen = []
    for name in ("tiled_conv3d", "tiled_conv3d_prefolded", "tiled_down2",
                 "tiled_up2", "tiled_up2_into"):
        fn = getattr(du, name)

        def spy(x, *a, _fn=fn, **kw):
            seen.append(x.dtype)
            return _fn(x, *a, **kw)

        monkeypatch.setattr(du, name, spy)
    return seen


def test_clis_at_float32_match_the_pipelines(tmp_path, scene, narrow, planted,
                                             captured, conv_dtypes):
    """eval_joint and eval_separate with tpu.conv_dtype=float32 (ARGS): the
    backbones run on float32 grids (the narrow net's stem and 16 block
    convs, 4 downs and 4 ups a pass, joint or a category), and the
    detections equal the float32 pipelines' on the same item."""
    assert "tpu.conv_dtype=float32" in ARGS
    overrides = write_scannet_tree(str(tmp_path), [scene])
    cfg = load_config(None, overrides + ARGS)
    ds = ScanNetXYZProbMultiDataset(cfg, training=False, augment=False)
    id_scan, coords, feats = ds[0][:3]

    eval_joint.main(overrides + ARGS)
    assert conv_dtypes and set(conv_dtypes) == {torch.float32}
    assert len(conv_dtypes) == PER_PASS
    torch.manual_seed(0)
    pipe = DetectionPipeline(
        model=narrow_unet(3, 64, compute_dtype="float32"), res=RES,
        peel=PeelConfig(res=RES, max_boxes=64), device="cpu")
    want = pipe.postprocess(pipe.run_scene_with_retry(
        pipe.prepare_quantized(coords, feats)))
    pred = captured[0][0]
    assert want and list(pred) == [id_scan]
    assert_same_detections(pred[id_scan], want)
    assert planted[0].dtype == torch.float32
    assert torch.equal(planted[0], planted[1])

    del conv_dtypes[:], captured[:], planted[:]
    eval_separate.main(overrides + ARGS)
    assert set(conv_dtypes) == {torch.float32}
    assert len(conv_dtypes) == len(ALL_CATEGORIES) * PER_PASS
    plan = narrow_unet(3, 8, compute_dtype="float32")
    sep = SeparateDetectionPipeline(
        model=plan, res=RES,
        peel=PeelConfig(res=RES, elimination_inclusive=False, max_boxes=64),
        device="cpu", **SEPARATE_KW)
    sep.set_state_dicts(category_state_dicts(plan, ALL_CATEGORIES))
    want = sep.detect(coords, feats)
    pred = captured[0][0]
    assert want
    assert_same_detections(pred[id_scan], want)
    assert torch.equal(planted[0], planted[1])
    assert np.isfinite(planted[0].numpy()).all()
