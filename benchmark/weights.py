"""Seeded weights on the device, made by the benchmark.

One state dict, drawn from `--seed` by a `torch.Generator` on the card in a
few large calls, fills the program's model (`load_state_dict`) and is read
as it is by the reference network. The distribution is the one the
repository's entry points use for random weights: layer-norm scales 1,
every bias 0, every other weight normal with standard deviation
1/sqrt(fan_in). Weights are float32, the type the program keeps its
parameters in (it casts them to its compute dtype at each product).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.network import Shape, fan_in, state_shapes


def make_state(shape: Shape, seed: int, device) -> dict:
    """{parameter name: float32 tensor on `device`} drawn from `seed`."""
    specs = state_shapes(shape)
    weights = [(n, s) for n, (s, k) in specs.items() if k == "weight"]
    sizes = [math.prod(s) for _, s in weights]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty(sum(sizes), device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    std = torch.tensor([1.0 / math.sqrt(fan_in(s)) for _, s in weights],
                       device=device)
    flat.mul_(torch.repeat_interleave(
        std, torch.tensor(sizes, device=device)))
    state = {n: t.view(s) for (n, s), t in
             zip(weights, torch.split(flat, sizes))}
    for kind, value in (("ln", 1.0), ("bias", 0.0)):
        names = [(n, s) for n, (s, k) in specs.items() if k == kind]
        sz = [math.prod(s) for _, s in names]
        buf = torch.full((sum(sz),), value, device=device)
        state.update({n: t.view(s) for (n, s), t in
                      zip(names, torch.split(buf, sz))})
    return state
