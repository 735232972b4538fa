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
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in a and b's dtype with float32 sums, as float32.

    bfloat16 on the card: ``torch.mm(..., out_dtype=torch.float32)``. Where
    that op has no kernel (the CPU) the bfloat16 operands are multiplied in
    float32, which is exact for their products and sums them in float32."""
    with _no_tf32():
        if a.dtype == torch.float32:
            return a @ b
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()


def sparse_conv_apply(feats: torch.Tensor, nbr: torch.Tensor,
                      weights: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(N_out, Cout) float32: ``feats`` (N_in, Cin), ``nbr`` (N_out, K) int32
    with -1 for a missing neighbor (read as zero), ``weights`` (K, Cin,
    Cout), optional ``bias`` (Cout,)."""
    dt = compute_dtype_of(compute_dtype)
    n_in, cin = feats.shape
    k, _, cout = weights.shape
    # row n_in of the source is the zero row that every -1 reads
    src = torch.cat([feats.to(dt), feats.new_zeros(1, cin, dtype=dt)])
    idx = torch.where(nbr >= 0, nbr, torch.full_like(nbr, n_in))
    gathered = src.index_select(0, idx.reshape(-1)).view(-1, k * cin)
    out = matmul_f32(gathered, weights.to(dt).reshape(k * cin, cout))
    return out if bias is None else out + bias


def sparse_conv1x1(feats: torch.Tensor, weights: torch.Tensor,
                   bias: Optional[torch.Tensor] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """kernel_size=1: a plain product, (N, Cin) x (1, Cin, Cout) or (Cin,
    Cout) -> (N, Cout) float32."""
    dt = compute_dtype_of(compute_dtype)
    w = weights.reshape(weights.shape[-2], weights.shape[-1])
    out = matmul_f32(feats.to(dt), w.to(dt))
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
