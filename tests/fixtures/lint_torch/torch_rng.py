"""Fixture: trips the port lint's ``module-rng`` rule exactly once (the
draws through a seeded ``torch.Generator`` below are allowed; the draw on
torch's global generator is not)."""

import torch

gen = torch.Generator().manual_seed(0)  # allowed: a generator of its own


def draws():
    seeded = torch.randn(3, generator=gen)
    order = torch.randperm(4, generator=gen)
    return seeded, order, torch.rand(3)
