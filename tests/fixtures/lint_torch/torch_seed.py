"""Fixture: trips the port lint's ``module-rng`` rule exactly once:
``torch.manual_seed`` reseeds torch's global generator."""

import torch


def reseed():
    torch.manual_seed(0)
    return torch.zeros(3)
