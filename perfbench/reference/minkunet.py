"""Plain MinkUNet over a gather sparse convolution: the benchmark's
reference backbone.

MinkowskiEngine's semantics (upstream ``utils/minkunet.py``) in plain
float32 PyTorch: a k=5 stem, four stride-2 down convs each followed by
residual basic blocks, four transposed up convs with the skip concatenated
after the up's output, and a 1x1 head with a bias. A conv at stride level
l reads, for every output voxel, the input voxels at the kernel's offsets
on the level's lattice (x-fastest offset order); a missing neighbour reads
zero. Parameter names are MinkowskiEngine's module names as the JAX tree
spells them (``conv0p1s1.kernel``, ``block1_0.norm1.scale``, ...).

Everything here is worked out from the voxel coordinates the benchmark
makes: the level coordinates, the neighbour tables, the occupied pairs.
Products run in float32 with TF32 off, or through ``quant`` (the control's
lower precision), forward and backward.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_BITS = 19
_OFF = 1 << (_BITS - 1)


@contextlib.contextmanager
def exact_float32():
    """float32 products and convs without TF32 inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ----------------------------------------------------------------- sites
@dataclass(frozen=True)
class Site:
    """One conv of the net: ``kind`` stem / down / up / sub / one / head;
    ``level`` its output level (the up: its fine level)."""

    name: str
    kind: str
    level: int
    cin: int
    cout: int
    k: int


def conv_sites(in_channels: int, out_channels: int, layers: Sequence[int],
               planes: Sequence[int], init_dim: int = 32,
               stem_kernel: int = 5) -> List[Site]:
    """Every conv of a basic-block MinkUNet, in forward order."""
    sites = [Site("conv0p1s1", "stem", 0, in_channels, init_dim, stem_kernel)]
    ch = init_dim

    def blocks(prefix, n, cin, p, lvl):
        out = []
        for j in range(n):
            out.append(Site(f"{prefix}_{j}.conv1", "sub", lvl, cin, p, 3))
            out.append(Site(f"{prefix}_{j}.conv2", "sub", lvl, p, p, 3))
            if cin != p:
                out.append(Site(f"{prefix}_{j}.downsample_conv", "one", lvl,
                                cin, p, 1))
            cin = p
        return out

    for i in range(4):
        sites.append(Site(f"conv{i + 1}p{1 << i}s2", "down", i + 1, ch, ch, 2))
        sites += blocks(f"block{i + 1}", layers[i], ch, planes[i], i + 1)
        ch = planes[i]
    skip_chs = [init_dim] + list(planes[:3])
    for d in range(4):
        lvl = 3 - d
        sites.append(Site(f"convtr{4 + d}p{1 << (lvl + 1)}s2", "up", lvl, ch,
                          planes[4 + d], 2))
        sites += blocks(f"block{5 + d}", layers[4 + d],
                        planes[4 + d] + skip_chs[lvl], planes[4 + d], lvl)
        ch = planes[4 + d]
    sites.append(Site("final", "head", 0, ch, out_channels, 1))
    return sites


def norm_name(site: Site) -> Optional[str]:
    """The BatchNorm that follows a conv (None for the head)."""
    if site.kind == "stem":
        return "bn0"
    if site.kind == "down":
        return f"bn{site.name[4]}"
    if site.kind == "up":
        return f"bntr{site.name[6]}"
    if site.kind == "sub":
        return site.name.replace(".conv", ".norm")
    if site.kind == "one":
        return site.name.replace("_conv", "_norm")
    return None


def param_specs(sites: Sequence[Site]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, role) of every parameter and statistic: role
    ``kernel``, ``bias`` (the head's), or a norm's ``scale`` / ``shift`` /
    ``mean`` / ``var``."""
    out = []
    for s in sites:
        out.append((f"{s.name}.kernel", (s.k ** 3, s.cin, s.cout), "kernel"))
        if s.kind == "head":
            out.append((f"{s.name}.bias", (s.cout,), "bias"))
            continue
        n = norm_name(s)
        for role, key in (("scale", "scale"), ("shift", "bias"),
                          ("mean", "mean"), ("var", "var")):
            out.append((f"{n}.{key}", (s.cout,), role))
    return out


# ------------------------------------------------------------- coordinates
def pack(c: torch.Tensor) -> torch.Tensor:
    """int64 keys of (N, 4) [batch, x, y, z] coordinates."""
    c = c.long()
    return ((((c[:, 0] << _BITS) | (c[:, 1] + _OFF)) << _BITS
             | (c[:, 2] + _OFF)) << _BITS) | (c[:, 3] + _OFF)


def offsets(k: int, lattice: int, device) -> torch.Tensor:
    """(k^3, 3) offsets on a lattice, x fastest: odd kernels centred, even
    ones {0 .. k-1} * lattice."""
    r = k // 2
    axis = (torch.arange(-r, r + 1) if k % 2 else torch.arange(k)) * lattice
    z, y, x = torch.meshgrid(axis, axis, axis, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)],
                       -1).to(device)


def downsample(c: torch.Tensor, stride: int) -> torch.Tensor:
    """The unique floor(c / stride) * stride of (N, 4) coordinates, sorted."""
    d = c.clone()
    d[:, 1:] = torch.div(d[:, 1:], stride, rounding_mode="floor") * stride
    keys, idx = torch.unique(pack(d), return_inverse=True)
    first = torch.full((len(keys),), len(d), dtype=torch.long, device=d.device)
    first.scatter_reduce_(0, idx, torch.arange(len(d), device=d.device), "amin")
    return d[first]


def table(in_c: torch.Tensor, out_c: torch.Tensor,
          offs: torch.Tensor) -> torch.Tensor:
    """(N_out, K) rows of ``in_c`` at ``out_c + offs[k]``, -1 where none."""
    keys = pack(in_c)
    sk, order = torch.sort(keys)
    q = out_c[:, None, :].clone().repeat(1, len(offs), 1)
    q[..., 1:] += offs[None]
    qk = pack(q.reshape(-1, 4))
    pos = torch.searchsorted(sk, qk).clamp_max(len(sk) - 1)
    hit = sk[pos] == qk
    return torch.where(hit, order[pos], torch.full_like(pos, -1)).view(
        len(out_c), len(offs))


@dataclass
class Geometry:
    """A batch's level coordinates and neighbour tables."""

    coords: List[torch.Tensor]     # per level (N_l, 4)
    stem: torch.Tensor
    conv: List[torch.Tensor]       # per level, k=3
    down: List[torch.Tensor]       # L_i -> L_{i+1}
    up: List[torch.Tensor]         # L_{i+1} -> L_i


def geometry(coords0: torch.Tensor, stem_kernel: int = 5,
             levels: int = 5) -> Geometry:
    """Level coordinates and tables of (N, 4) stride-1 voxel coordinates;
    level 0 keeps the rows' own order."""
    dev = coords0.device
    cs = [coords0.long()]
    for lvl in range(1, levels):
        cs.append(downsample(cs[-1], 1 << lvl))
    conv = [table(cs[l], cs[l], offsets(3, 1 << l, dev)) for l in range(levels)]
    stem = table(cs[0], cs[0], offsets(stem_kernel, 1, dev))
    down, up = [], []
    for l in range(levels - 1):
        o = offsets(2, 1 << l, dev)
        down.append(table(cs[l], cs[l + 1], o))
        up.append(table(cs[l + 1], cs[l], -o))
    return Geometry(cs, stem, conv, down, up)


def occupied_pairs(geo: Geometry, site: Site) -> int:
    """The (output, tap) pairs of ``site`` whose input voxel is occupied."""
    if site.kind in ("one", "head"):
        return int(len(geo.coords[site.level]))
    t = {"stem": lambda: geo.stem, "sub": lambda: geo.conv[site.level],
         "down": lambda: geo.down[site.level - 1],
         "up": lambda: geo.up[site.level]}[site.kind]()
    return int((t >= 0).sum())


# ---------------------------------------------------------------- forward
def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale: the control's
    precision, the one below the configurations' bfloat16 products."""
    s = 448.0 / t.detach().abs().max().clamp_min(1e-30)
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


def bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, the configurations' products."""
    return t.to(torch.bfloat16).to(t.dtype)


# the backward's control: the forward's products at the configuration's
# bfloat16, the backward's in float8
BACKWARD_FP8 = (bf16, fp8)


class _Mm(torch.autograd.Function):
    """a @ b with both operands through ``quant``, forward and backward; a
    pair ``(forward, backward)`` rounds the two passes' products apart."""

    @staticmethod
    def forward(ctx, a, b, quant):
        ctx.save_for_backward(a, b)
        fq, ctx.quant = quant if isinstance(quant, tuple) else (quant, quant)
        return fq(a) @ fq(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.quant
        ga = q(g) @ q(b).t() if ctx.needs_input_grad[0] else None
        gb = q(a).t() @ q(g) if ctx.needs_input_grad[1] else None
        return ga, gb, None


def mm(a, b, quant=None):
    return (a @ b) if quant is None else _Mm.apply(a, b, quant)


def sparse_conv(x: torch.Tensor, tab: torch.Tensor, w: torch.Tensor,
                quant=None) -> torch.Tensor:
    """out[m] = sum_k x[tab[m, k]] @ w[k], zero rows for -1."""
    xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
    idx = torch.where(tab >= 0, tab, torch.full_like(tab, len(x)))
    g = torch.index_select(xz, 0, idx.reshape(-1)).view(len(tab), -1)
    return mm(g, w.reshape(-1, w.shape[-1]), quant)


def batch_norm(x, P, name, train: bool, eps: float = 1e-5):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = P[f"{name}.mean"], P[f"{name}.var"]
    return (x - mean) * torch.rsqrt(var + eps) * P[f"{name}.scale"] \
        + P[f"{name}.bias"]


def forward(P: Dict[str, torch.Tensor], feats: torch.Tensor, geo: Geometry,
            layers: Sequence[int], train: bool = False,
            quant: Optional[Callable] = None) -> torch.Tensor:
    """(N0, out) float32 head rows of the level-0 voxels, in their order."""

    def conv(x, tab, name):
        return sparse_conv(x, tab, P[f"{name}.kernel"], quant)

    def bn(x, name):
        return batch_norm(x, P, name, train)

    def blocks(prefix, n, x, lvl):
        for j in range(n):
            b = f"{prefix}_{j}"
            out = torch.relu(bn(conv(x, geo.conv[lvl], f"{b}.conv1"), f"{b}.norm1"))
            out = bn(conv(out, geo.conv[lvl], f"{b}.conv2"), f"{b}.norm2")
            res = x
            if f"{b}.downsample_conv.kernel" in P:
                res = bn(mm(x, P[f"{b}.downsample_conv.kernel"][0], quant),
                         f"{b}.downsample_norm")
            x = torch.relu(out + res)
        return x

    out_p1 = torch.relu(bn(conv(feats, geo.stem, "conv0p1s1"), "bn0"))
    x, skips = out_p1, []
    for i in range(4):
        x = torch.relu(bn(conv(x, geo.down[i], f"conv{i + 1}p{1 << i}s2"),
                          f"bn{i + 1}"))
        x = blocks(f"block{i + 1}", layers[i], x, i + 1)
        skips.append(x)
    x = skips[3]
    for d in range(4):
        lvl = 3 - d
        up = torch.relu(bn(conv(x, geo.up[lvl], f"convtr{4 + d}p{1 << (lvl + 1)}s2"),
                           f"bntr{4 + d}"))
        skip = skips[lvl - 1] if lvl >= 1 else out_p1
        x = blocks(f"block{5 + d}", layers[4 + d], torch.cat([up, skip], -1), lvl)
    return mm(x, P["final.kernel"][0], quant) + P["final.bias"]
