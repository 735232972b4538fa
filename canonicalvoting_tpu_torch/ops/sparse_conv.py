"""Gather-form sparse convolution: one gather, then one GEMM.

The port's counterpart of ``canonicalvoting_tpu/ops/sparse_conv.py``. Given a
host-built neighbor table ``nbr`` (N_out, K) (``ops/coords.py``):

    gathered[m, k] = feats[nbr[m, k]]          (0 where nbr[m, k] == -1)
    out[m]         = sum_k gathered[m, k] @ W[k]

as one (N_out, K * Cin) x (K * Cin, Cout) product. The JAX package computes
it in XLA, outside any Pallas kernel, and so does the port: a cuBLAS product.
The operands are cast to the compute dtype before the gather (the gather is
the large tensor: ~0.4 GB in bfloat16 at a ScanNet scene's L0) and the
product returns float32, as the JAX package's ``preferred_element_type``
does: bfloat16 operands multiply with float32 sums and a float32 result,
one rounding fewer than a bfloat16 output. Float32 products run without
TF32.

Training differentiates both convs through one ``torch.autograd.Function``
each (:class:`GatherMatmul`, :class:`CastMatmul`), whose backward is the
one JAX derives for the same forward:

    d_gathered = bf16(dY @ W^T)       scatter-added in float32 into d_feats
    dW         = bf16(gathered^T @ dY)

The float32 ``feats`` are cast inside the Function, so the 27 (or 125)
taps of a row add into ``d_feats`` in float32, not in bfloat16, and the -1
taps (the zero row) take no gradient. The weight enters already cast, so
``.to(bfloat16)``'s own backward turns ``dW`` into the float32 parameter's
gradient. The Function keeps the bfloat16 source and the index, not the
(rows, K * Cin) gathered operand: the backward gathers it again. Two
routes compute the backward products: the plain one (CPU tensors) takes
float32 ``dY`` times the bfloat16-exact operand with float32 sums, as the
JAX package does; the card's rounds ``dY`` to bfloat16 and multiplies with
cuBLAS into float32 (``torch.mm(..., out_dtype=torch.float32)``), as a TPU
multiplies a float32 by a bfloat16 operand at its default precision. On
the card ``index_add_`` adds with atomics, so its gradients are not
bitwise repeatable.

Under mesh training a conv whose kernel is split over the model ranks'
output columns runs :class:`ColumnGatherMatmul` (:func:`column_parallel_conv`):
this rank's product with its column slice, the columns all-gathered in the
forward. Every model rank then computes the same loss, so the backward
takes this rank's slice of the output gradient for the slice's ``dW``, and
the whole output gradient with the kernel all-gathered (a few MB) for
``d_feats``: the input gradient of one rank's conv, the same on every
model rank, with no activation-sized reduction over the model group.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from canonicalvoting_tpu_torch.parallel.collectives import (
    all_gather_columns, column_slice)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_of(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _plain_route(t: torch.Tensor) -> bool:
    """The plain route serves CPU tensors only; any other device (the card,
    or meta tensors) takes the card's ops."""
    return t.device.type == "cpu"


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in a and b's dtype with float32 sums, as float32.

    bfloat16 on the card: ``torch.mm(..., out_dtype=torch.float32)``. Where
    that op has no kernel (the CPU) the bfloat16 operands are multiplied in
    float32, which is exact for their products and sums them in float32."""
    with _no_tf32():
        if a.dtype == torch.float32:
            return a @ b
        if not _plain_route(a):
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()


def grad_matmul(a: torch.Tensor, b: torch.Tensor,
                plain: Optional[bool] = None) -> torch.Tensor:
    """A backward product: one float32 operand (the output's gradient) and
    one in the compute dtype, as float32 with float32 sums. ``plain`` (the
    default on CPU tensors) multiplies the float32 operand by the other one
    exactly; the card's route rounds the float32 operand to the compute
    dtype first."""
    dt = b.dtype if a.dtype == torch.float32 else a.dtype
    if plain is None:
        plain = _plain_route(a)
    with _no_tf32():
        if dt == torch.float32 or plain:
            return a.float() @ b.float()
        return torch.mm(a.to(dt), b.to(dt), out_dtype=torch.float32)


def gather_rows(src: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """``src[idx]`` as (rows, width): the gathered operand of a conv."""
    return src.index_select(0, idx).view(-1, width)


def gather_matmul_grads(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        dy: torch.Tensor, need_feats: bool = True,
                        need_w: bool = True, plain: Optional[bool] = None):
    """(d_feats, dW) of ``gather_rows(src, idx) @ w`` for the output
    gradient ``dy``: ``src`` (N_in + 1, Cin) in the compute dtype with the
    zero row last, ``idx`` (N_out * K,) its rows, ``w`` (K * Cin, Cout).
    ``d_feats`` (N_in, Cin) float32 sums ``d_gathered`` rounded to the
    compute dtype, in float32; ``dW`` is in the compute dtype."""
    dt, cin = w.dtype, src.shape[1]
    d_feats = dw = None
    if need_feats:
        dg = grad_matmul(dy, w.t(), plain).to(dt).float()
        d_src = dy.new_zeros(src.shape).index_add_(0, idx, dg.view(-1, cin))
        d_feats = d_src[:-1]
    if need_w:
        dw = grad_matmul(gather_rows(src, idx, w.shape[0]).t(), dy, plain).to(dt)
    return d_feats, dw


class GatherMatmul(torch.autograd.Function):
    """``feats`` (N_in, Cin) -> gather ``idx`` (rows of the source, N_in the
    zero row) -> product with ``w`` (K * Cin, Cout), in ``w``'s dtype with
    a float32 result."""

    @staticmethod
    def forward(ctx, feats, idx, w):
        dt = w.dtype
        src = torch.cat([feats.to(dt), feats.new_zeros(1, feats.shape[1], dtype=dt)])
        ctx.save_for_backward(src, idx, w)
        ctx.feats_dtype = feats.dtype
        return matmul_f32(gather_rows(src, idx, w.shape[0]), w)

    @staticmethod
    def backward(ctx, dy):
        src, idx, w = ctx.saved_tensors
        d_feats, dw = gather_matmul_grads(
            src, idx, w, dy.float(), need_feats=ctx.needs_input_grad[0],
            need_w=ctx.needs_input_grad[2])
        if d_feats is not None:
            d_feats = d_feats.to(ctx.feats_dtype)
        return d_feats, None, dw


class CastMatmul(torch.autograd.Function):
    """``a`` (M, K) @ ``b`` (K, N), both in the compute dtype, as float32:
    the 1x1 conv. Its gradients are rounded to the compute dtype, and the
    casts before it carry them to float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_f32(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.float()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = grad_matmul(dy, b.t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = grad_matmul(a.t(), dy).to(b.dtype)
        return da, db


class ColumnGatherMatmul(torch.autograd.Function):
    """:class:`GatherMatmul` (``idx`` given) or :class:`CastMatmul`
    (``idx`` None: the 1x1) with ``w`` this rank's column slice of the
    kernel over ``mesh``'s model group: gather forward (the output's
    columns), slice backward (``dW`` from this rank's columns of the
    output gradient; ``d_feats`` from all of it and the gathered kernel)."""

    @staticmethod
    def forward(ctx, feats, idx, w, mesh):
        dt = w.dtype
        if idx is None:
            src = feats.to(dt)
            out = matmul_f32(src, w)
        else:
            src = torch.cat([feats.to(dt), feats.new_zeros(1, feats.shape[1],
                                                           dtype=dt)])
            out = matmul_f32(gather_rows(src, idx, w.shape[0]), w)
        ctx.save_for_backward(src, idx, w)
        ctx.mesh, ctx.feats_dtype = mesh, feats.dtype
        return all_gather_columns(out, mesh)

    @staticmethod
    def backward(ctx, dy):
        src, idx, w = ctx.saved_tensors
        dy = dy.float()
        mine = column_slice(dy, ctx.mesh).contiguous()
        d_feats = dw = None
        if ctx.needs_input_grad[0]:
            w_all = all_gather_columns(w.float(), ctx.mesh).to(w.dtype)
            if idx is None:
                d_feats = grad_matmul(dy, w_all.t()).to(w.dtype)
            else:
                d_feats, _ = gather_matmul_grads(src, idx, w_all, dy,
                                                 need_w=False)
            d_feats = d_feats.to(ctx.feats_dtype)
        if ctx.needs_input_grad[2]:
            if idx is None:
                dw = grad_matmul(src.t(), mine).to(w.dtype)
            else:
                _, dw = gather_matmul_grads(src, idx, w, mine, need_feats=False)
        return d_feats, None, dw, None


def column_parallel_conv(feats: torch.Tensor, nbr: Optional[torch.Tensor],
                         weights: torch.Tensor, mesh,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N_out, Cout) float32 of a conv whose ``weights`` (K, Cin, Cout /
    model) are this rank's columns (:class:`ColumnGatherMatmul`); ``nbr``
    None for a 1x1."""
    dt = compute_dtype_of(compute_dtype)
    k, cin, cout = weights.shape
    idx = None if nbr is None else conv_index(nbr, feats.shape[0])
    return ColumnGatherMatmul.apply(feats, idx, weights.to(dt).reshape(k * cin, cout),
                                    mesh)


def conv_index(nbr: torch.Tensor, n_in: int) -> torch.Tensor:
    """The flat source rows of a neighbor table: -1 reads row ``n_in``, the
    zero row."""
    return torch.where(nbr >= 0, nbr, torch.full_like(nbr, n_in)).reshape(-1)


def sparse_conv_apply(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N_out, Cout) float32: ``feats`` (N_in, Cin), ``nbr`` (N_out, K) int32
    with -1 for a missing neighbor (read as zero), ``weights`` (K, Cin,
    Cout), optional ``bias`` (Cout,)."""
    dt = compute_dtype_of(compute_dtype)
    k, cin, cout = weights.shape
    out = GatherMatmul.apply(feats, conv_index(nbr, feats.shape[0]),
                             weights.to(dt).reshape(k * cin, cout))
    return out if bias is None else out + bias


def sparse_conv1x1(feats: torch.Tensor, weights: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """kernel_size=1: a plain product, (N, Cin) x (1, Cin, Cout) or (Cin,
    Cout) -> (N, Cout) float32."""
    dt = compute_dtype_of(compute_dtype)
    w = weights.reshape(weights.shape[-2], weights.shape[-1])
    out = CastMatmul.apply(feats.to(dt), w.to(dt))
    return out if bias is None else out + bias


def valid_row_mask(n_rows: int, nvalid: int, device=None) -> torch.Tensor:
    """(n_rows, 1) float32 mask of the real (non-padding) rows."""
    idx = torch.arange(n_rows, device=device)[:, None]
    return (idx < nvalid).float()


def masked_global_pool(feats: torch.Tensor, nvalid: int,
                       mode: str = "max") -> torch.Tensor:
    """Global pooling over the valid rows (MinkowskiEngine's global max /
    average pooling)."""
    mask = valid_row_mask(feats.shape[0], nvalid, feats.device)
    if mode == "max":
        big = torch.finfo(feats.dtype).min
        return torch.where(mask > 0, feats, torch.full_like(feats, big)).max(0).values
    s = (feats * mask).sum(0)
    return s / torch.clamp_min(mask.sum(), 1.0)
