"""Category-grouped evaluation: N per-category MinkUNets run as one net.

Counterpart of ``canonicalvoting_tpu/eval/grouped.py``, over the port's
state dicts. A grouped model is another ``DenseMinkUNet`` whose channel plan
is N times the per-category plan; its conv kernels are block-diagonal
embeddings of the N categories' kernels and its BatchNorm parameters and
statistics concatenate. The arithmetic is block-diagonal through conv, BN,
mask, ReLU and the skip concats, so the grouped net's head rows are the N
per-category nets' rows, category-major. It needs no kernel of its own.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def _embed_kernel(ws: Sequence[torch.Tensor], in_segs: Sequence[int]) -> torch.Tensor:
    """Block-diagonal embedding of N (K, cin, cout) kernels. ``in_segs`` are
    the per-category sizes of the input's channel segments (concat order),
    summing to cin. The grouped input is laid out [seg1 cat0..catN-1 | seg2
    cat0..catN-1 | ...], as the grouped net produces it at every concat;
    output channels are category-major."""
    n = len(ws)
    k, cin, cout = ws[0].shape
    if sum(in_segs) != cin:
        raise ValueError(f"segments {in_segs} do not sum to {cin}")
    out = torch.zeros(k, n * cin, n * cout, dtype=torch.float32)
    for c, w in enumerate(ws):
        r0 = g0 = 0  # row offset in the category's kernel, segment offset
        for s in in_segs:
            out[:, g0 + c * s:g0 + (c + 1) * s, c * cout:(c + 1) * cout] = \
                w[:, r0:r0 + s].float()
            r0 += s
            g0 += n * s
    return out


def grouped_model_config(model, n: int) -> Dict:
    """Constructor keywords of the grouped ``DenseMinkUNet`` twin of the
    per-category ``model`` covering ``n`` categories (basic blocks, the
    port's only block)."""
    cfg = model.config()
    cfg.update(out_channels=n * model.out_channels,
               planes=tuple(n * p for p in model.planes),
               init_dim=n * model.init_dim)
    return cfg


def build_grouped_state(state_dicts: List[Dict[str, torch.Tensor]],
                        model) -> Dict[str, torch.Tensor]:
    """Merge N per-category state dicts of ``model``'s plan into the grouped
    model's state dict. The stem's input (the scene's features) is shared, so
    its kernels concatenate output channels; every decoder stack's first
    block sees the [transposed-conv out | skip] concat (two segments)."""
    planes, init_dim = tuple(model.planes), model.init_dim
    enc_in = [init_dim] + list(planes[:3])
    skip_chs = [init_dim] + list(planes[:3])

    def seg_spec(key: str) -> List[int]:
        mod, *rest = key.split(".")
        if mod == "final":
            return [planes[7]]
        if mod.startswith("convtr"):
            d = int(mod[6]) - 4  # convtr4..convtr7
            return [planes[3] if d == 0 else planes[4 + d - 1]]
        if mod.startswith("conv"):  # conv1p1s2..conv4p8s2
            return [enc_in[int(mod[4]) - 1]]
        b, j = (int(v) for v in mod[5:].split("_"))  # block<b>_<j>
        width = planes[b - 1]  # the stack's plane width
        if rest[0] == "conv2":  # its input is conv1's output
            return [width]
        if b <= 4:
            return [enc_in[b - 1] if j == 0 else width]
        if j == 0:
            return [planes[b - 1], skip_chs[3 - (b - 5)]]
        return [width]

    out = {}
    for key in state_dicts[0]:
        leaves = [sd[key] for sd in state_dicts]
        if not key.endswith(".kernel"):
            out[key] = torch.cat([t.float() for t in leaves])
        elif key.startswith("conv0p1s1."):
            out[key] = torch.cat([t.float() for t in leaves], dim=2)
        else:
            out[key] = _embed_kernel(leaves, seg_spec(key))
    return out
