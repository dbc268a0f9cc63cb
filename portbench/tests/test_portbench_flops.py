"""The benchmark's FLOP count against torch's own counter on the plain
reference's passes, at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.harness import flops, weights
from portbench.reference import models

M = {"ngf": 8, "ndf": 8, "n_blocks": 2, "n_layers_D": 3, "n_bins": 10,
     "cmp_nf": 8, "cmp_n_down": 3, "crop": 32, "comparator": True}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def nets():
    w = weights.draw(M, 5, torch.device("cpu"))
    return {k: {n: t.clone() for n, t in v.items()} for k, v in w.items()}


def _x(n, grad=False):
    x = torch.rand(n, M["crop"], M["crop"], 3) * 2 - 1
    return x.requires_grad_(grad)


def _c(n):
    return torch.eye(M["n_bins"])[torch.arange(n) % M["n_bins"]]


def test_g_pass_with_weight_gradients(nets):
    g = {k: v.requires_grad_(True) for k, v in nets["G"].items()}

    def run():
        out = models.generator(g, _x(4), _c(4), M["n_blocks"])
        torch.autograd.grad(out.square().sum(), list(g.values()))
    layers = flops.g_layers(M["crop"], M["ngf"], M["n_blocks"], M["n_bins"])
    assert _counted(run) == flops.pass_flops(layers, 4, "weights")


def test_d_update_and_input_gradient_passes(nets):
    d = {k: v.requires_grad_(True) for k, v in nets["D"].items()}
    layers = flops.d_layers(M["crop"], M["ndf"], M["n_bins"])

    def update():
        out = models.discriminator(d, _x(4), _c(4))
        torch.autograd.grad(out.square().sum(), list(d.values()))
    assert _counted(update) == flops.pass_flops(layers, 4, "weights")
    frozen = {k: v.detach() for k, v in d.items()}

    def through():
        x = _x(2, grad=True)
        torch.autograd.grad(models.discriminator(frozen, x, _c(2)).sum(), x)
    assert _counted(through) == flops.pass_flops(layers, 2, "inputs")


def test_comparator_input_gradient_pass(nets):
    c = {k: v.detach() for k, v in nets["C"].items()}
    layers = flops.c_layers(M["crop"], M["cmp_nf"], M["cmp_n_down"])

    def through():
        x = _x(3, grad=True)
        mu, lv = models.comparator(c, x, M["cmp_n_down"])
        torch.autograd.grad((mu + lv).sum(), x)
    assert _counted(through) == flops.pass_flops(layers, 3, "inputs")


def test_step_and_grid_totals_add_the_passes():
    b = 4
    g = flops.g_layers(M["crop"], M["ngf"], M["n_blocks"], M["n_bins"])
    d = flops.d_layers(M["crop"], M["ndf"], M["n_bins"])
    c = flops.c_layers(M["crop"], M["cmp_nf"], M["cmp_n_down"])
    assert flops.train_step_flops(M, b) == (
        flops.pass_flops(g, 2 * b, "weights")
        + flops.pass_flops(d, 2 * b, "weights")
        + flops.pass_flops(d, b, "inputs") + flops.pass_flops(c, b, "inputs"))
    assert flops.grid_flops(M, 3) == sum(g) * 3 * M["n_bins"]
