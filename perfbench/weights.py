"""Random weights drawn on the device from ``--seed``, in the dtype they
are served in, in a few large calls: the model is built on the meta
device, every parameter becomes a view of one flat buffer per dtype, the
buffer is filled with standard normal draws from one ``torch.Generator``
on the card in blocks of 2**28, and each view is scaled by its fan-in
(the reference family's ``fan_in``: 1 / sqrt(fan-in), 1 for the
embedding; norm scales 0.1 x normal, around the port's ``1 + scale``).
The same tensors go to the program and to the reference."""
from __future__ import annotations

import torch
from torch import nn

BLOCK = 2 ** 28
ALIGN = 256  # elements: every view starts 512-byte aligned or better


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(abs(int(seed)) % (2 ** 63))
    return g


def materialize(model: nn.Module, seed: int, device, fan_in) -> dict:
    """Give every parameter of a meta-device ``model`` random values on
    ``device``. Returns ``{name: tensor}`` (the views)."""
    named = list(model.named_parameters())
    sizes: dict[torch.dtype, int] = {}
    offsets = []
    for name, p in named:
        off = sizes.get(p.dtype, 0)
        offsets.append(off)
        sizes[p.dtype] = off + -(-p.numel() // ALIGN) * ALIGN
    g = generator(seed, device)
    bufs = {}
    for dt, n in sizes.items():
        buf = torch.empty(n, dtype=dt, device=device)
        for i in range(0, n, BLOCK):
            buf[i:i + BLOCK].normal_(generator=g)
        bufs[dt] = buf
    out = {}
    owners = {}
    for mod_name, mod in model.named_modules():
        for pname in mod._parameters:
            owners[f"{mod_name}.{pname}" if mod_name else pname] = (mod, pname)
    with torch.no_grad():
        for (name, p), off in zip(named, offsets):
            view = bufs[p.dtype][off:off + p.numel()].view(p.shape)
            f = fan_in(name, tuple(p.shape))
            view.mul_(0.1 if f is None else float(f) ** -0.5)
            mod, pname = owners[name]
            mod._parameters[pname] = nn.Parameter(view, requires_grad=False)
            out[name] = view
    return out
