"""The sparse conv's backward (ops/sparse_conv.py: GatherMatmul, CastMatmul)
against jax.grad of the JAX package's sparse_conv_apply / sparse_conv1x1 on
the CPU, and the card route's backward on meta tensors.

Tolerances, of each gradient's peak: float32 within 1e-5 (both sides sum in
float32, in other orders); bfloat16 within 2e-3: both round d_gathered and
dW to bfloat16 after a float32 sum, and a sum taken in another order moves
that rounding by one bfloat16 step (2^-8 relative) now and then; the
float32 scatter-add of d_feats then carries such a step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canonicalvoting_tpu.ops import sparse_conv as jsc
from canonicalvoting_tpu.ops.coords import PyramidSpec, build_pyramid
from canonicalvoting_tpu.ops.voxelize import batched_coordinates, sparse_quantize

from canonicalvoting_tpu_torch.ops import sparse_conv as tsc

from tests.test_torch_dense_unet import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-3)}


@pytest.fixture(scope="module")
def pyr():
    """Two scenes of ~1,000 voxels in a 256-row padded pyramid: tables
    with -1 taps and padding rows."""
    rng = np.random.RandomState(0)
    cl = [sparse_quantize(rng.uniform(0, 1.0, (1200, 3)).astype(np.float32),
                          0.03)[0] for _ in range(2)]
    return build_pyramid(batched_coordinates(cl), PyramidSpec(cap_multiple=256))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    peak = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * peak, (err, rel * peak)


CASES = {"stem": lambda p: (p.nbr_stem, 0), "conv": lambda p: (p.nbr_conv[1], 1),
         "down": lambda p: (p.nbr_down[0], 0), "up": lambda p: (p.nbr_up[1], 2)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", CASES)
def test_gather_conv_grads_match_jax(pyr, kind, dtype):
    """d_feats and dW (and the bias's gradient) for k=5, k=3, the k=2 down
    and up tables, under a random output gradient."""
    nbr, lvl_in = CASES[kind](pyr)
    assert (nbr == -1).any() and (nbr[-1] == -1).all()  # a padding row
    rng = np.random.RandomState(1)
    n_in = pyr.coords[lvl_in].shape[0]
    x = rng.randn(n_in, 12).astype(np.float32)
    w = (rng.randn(nbr.shape[1], 12, 10) * 0.1).astype(np.float32)
    b = rng.randn(10).astype(np.float32)
    g = rng.randn(nbr.shape[0], 10).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]

    def f(x, w, b):
        return jnp.sum(jsc.sparse_conv_apply(x, nbr, w, b, compute_dtype=jdt) * g)

    jx, jw, jb = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(x, w, b)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = tsc.sparse_conv_apply(tx, torch.from_numpy(nbr), tw, tb,
                                compute_dtype=tdt)
    out.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tw.grad.dtype == torch.float32
    _close(tx.grad, jx, tol)
    _close(tw.grad, jw, tol)
    _close(tb.grad, jb, 1e-6)
    # unreferenced rows (padding and rows no table entry reads) take none
    unread = np.setdiff1d(np.arange(n_in), nbr[nbr >= 0])
    assert len(unread) and not tx.grad[unread].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1x1_grads_match_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(300, 40).astype(np.float32)
    w = (rng.randn(1, 40, 24) * 0.2).astype(np.float32)
    g = rng.randn(300, 24).astype(np.float32)
    jdt, tdt, tol = DTYPES[dtype]

    def f(x, w):
        return jnp.sum(jsc.sparse_conv1x1(x, w, compute_dtype=jdt) * g)

    jx, jw = jax.jit(jax.grad(f, argnums=(0, 1)))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tsc.sparse_conv1x1(tx, tw, compute_dtype=tdt).backward(torch.from_numpy(g))
    _close(tx.grad, jx, tol)
    _close(tw.grad, jw, tol)


def test_backward_keeps_the_source_not_the_gathered_operand(pyr):
    """The Function saves the (N_in + 1, Cin) source and the index; the
    (rows, K * Cin) operand is gathered again in the backward."""
    nbr = pyr.nbr_conv[0]
    x = torch.randn(nbr.shape[0], 8, requires_grad=True)
    w = torch.randn(27, 8, 4, requires_grad=True)
    out = tsc.sparse_conv_apply(x, torch.from_numpy(nbr), w)
    saved = out.grad_fn.saved_tensors
    assert sorted(tuple(t.shape) for t in saved) == sorted(
        [(nbr.shape[0] + 1, 8), (nbr.size,), (27 * 8, 4)])


def test_card_route_backward_runs_on_meta_tensors(monkeypatch):
    """Meta tensors take the card's route: the forward and both backward
    products go through torch.mm(..., out_dtype=torch.float32), which has no
    autograd formula of its own; the Function's backward gives float32
    gradients of the parameters' shapes."""
    calls = []
    mm = torch.mm

    def spy(*args, **kw):
        calls.append((args[0].dtype, args[1].dtype, kw.get("out_dtype")))
        return mm(*args, **kw)

    x = torch.empty(300, 16, device="meta", requires_grad=True)
    w = torch.empty(27, 16, 24, device="meta", requires_grad=True)
    w1 = torch.empty(1, 24, 8, device="meta", requires_grad=True)
    nbr = torch.empty(250, 27, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="derivative for aten::mm"):
        a = torch.empty(4, 5, device="meta", dtype=torch.bfloat16,
                        requires_grad=True)
        mm(a, torch.empty(5, 3, device="meta", dtype=torch.bfloat16),
           out_dtype=torch.float32).sum().backward()
    monkeypatch.setattr(torch, "mm", spy)
    out = tsc.sparse_conv1x1(tsc.sparse_conv_apply(x, nbr, w), w1)
    assert out.dtype == torch.float32 and out.shape == (250, 8)
    out.sum().backward()
    assert x.grad.dtype == w.grad.dtype == w1.grad.dtype == torch.float32
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert w1.grad.shape == w1.shape
    # 2 forward products, then 2 a conv backward (d_feats, dW)
    assert len(calls) == 6
    assert all(c == (torch.bfloat16, torch.bfloat16, torch.float32)
               for c in calls)


def test_plain_route_serves_cpu_tensors():
    """On CPU tensors the backward products take the plain route: the
    float32 gradient times the bfloat16 operand exactly, with float32
    sums (the card's route would round the gradient to bfloat16 first)."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    b = torch.from_numpy(rng.randn(32, 16).astype(np.float32)).bfloat16()
    assert torch.equal(tsc.grad_matmul(a, b), a @ b.float())
    assert not torch.equal(tsc.grad_matmul(a, b),
                           a.bfloat16().float() @ b.float())
