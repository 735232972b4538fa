"""Random weights made on the device from the run's seed, in a few large
draws: Kaiming-normal kernels over fan-out (the upstream initialisation)
and BatchNorm parameters and statistics drawn near the identity, so that
every folded affine of the program is exercised. Float32, as the models
keep them."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from harness.scenes import sub_seed


def make(torch, specs: Sequence[Tuple[str, Tuple[int, ...], str]], n_models: int,
         seed: int, device, stream: int = 0) -> List[Dict[str, "torch.Tensor"]]:
    """``n_models`` state dicts of ``specs`` (reference/minkunet.param_specs);
    ``stream`` separates draws of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, 2, stream))
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    big = [n for (_, _, role), n in zip(specs, sizes) if role == "kernel"]
    small = [n for (_, _, role), n in zip(specs, sizes) if role != "kernel"]
    normal = torch.randn(sum(big) * n_models, generator=g, device=device)
    z_small = torch.randn(sum(small) * n_models, generator=g, device=device)
    u_small = torch.rand(sum(small) * n_models, generator=g, device=device) * 2 - 1
    out, ob, os_ = [], 0, 0
    for _ in range(n_models):
        sd = {}
        for (name, shape, role), n in zip(specs, sizes):
            if role == "kernel":
                z = normal[ob:ob + n].view(shape)
                ob += n
                sd[name] = z * (2.0 / (shape[0] * shape[2])) ** 0.5
                continue
            z, u = z_small[os_:os_ + n].view(shape), u_small[os_:os_ + n].view(shape)
            os_ += n
            if role == "scale":
                sd[name] = 1.0 + 0.2 * u
            elif role == "var":
                sd[name] = 1.0 + 0.5 * u
            else:  # a norm's shift or mean, the head's bias
                sd[name] = 0.1 * z
        out.append(sd)
    return out
