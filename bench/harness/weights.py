"""The weights of a run, drawn from its seed on the device.

One ``torch.Generator`` on the run's device, seeded from ``--seed``, draws
standard normals in float32 in chunks of ``CHUNK`` elements, a few large
calls for the whole model; each weight of the reference's
``weight_spec`` takes the next ``numel`` of them, times its scale, in the
spec's order (a weight of constant fill takes none). The same seed gives
the same weights, so the program's parameters and the reference's float32
weights are the same numbers, and the initial weights can be drawn again
name by name to measure how far training moved them.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import torch

#: normals drawn a call (512 MB of float32)
CHUNK = 1 << 27
#: keeps the weights' stream apart from other draws of the same seed
_SALT = 0x5EED_0001


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + _SALT) % (1 << 63))


def draw(spec, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, float32 tensor)`` for each weight of ``spec`` in order. A
    yielded tensor may be a view of the current chunk: copy it before
    asking for the next."""
    gen = generator(seed, device)
    buf, at = None, CHUNK
    for name, shape, fill in spec:
        n = 1
        for s in shape:
            n *= s
        kind = fill[0]
        if kind == "const":
            yield name, torch.full(shape, float(fill[1]), dtype=torch.float32, device=device)
            continue
        if kind == "blocks":
            yield name, torch.cat([torch.full((c,), float(v), device=device)
                                   for c, v in fill[1]]).view(shape)
            continue
        parts, need = [], n
        while need:
            if at == CHUNK:
                buf = torch.randn(CHUNK, generator=gen, device=device, dtype=torch.float32)
                at = 0
            take = min(need, CHUNK - at)
            parts.append(buf[at:at + take])
            at += take
            need -= take
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        yield name, (flat * fill[1]).view(shape)


def load_into(named, spec, seed: int) -> None:
    """Copy the drawn weights into ``named`` (name -> parameter, any dtype),
    which must hold exactly the spec's names and shapes."""
    named = dict(named)
    want = {name: tuple(shape) for name, shape, _ in spec}
    have = {name: tuple(p.shape) for name, p in named.items()}
    if want != have:
        missing = sorted(set(want) - set(have))[:5]
        extra = sorted(set(have) - set(want))[:5]
        shapes = sorted(k for k in set(want) & set(have) if want[k] != have[k])[:5]
        raise ValueError(f"the program's parameters are not the reference's: missing "
                         f"{missing}, unknown {extra}, other shapes {shapes}")
    device = next(iter(named.values())).device
    with torch.no_grad():
        for name, w in draw(spec, seed, device):
            named[name].copy_(w)
