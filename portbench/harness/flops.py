"""Model FLOPs of PC-GAN's passes, counted from the configuration's shapes.

A convolution costs 2 * N * C_out * H_out * W_out * C_in * k * k; a
transposed one 2 * N * C_in * H_in * W_in * C_out * k * k; a linear layer
2 * N * in * out. Elementwise work, norms and pads are not counted. A
backward pass costs one forward for the weight gradients and one for the
input gradients, of every layer whose input needs a gradient: the first
layer of a pass on images that need none takes the weight gradient only.
Recomputation is not counted. The stem's condition channels count in full
(the model's concatenated form), whatever route the program takes.
"""

from __future__ import annotations

from typing import Dict, List


def _out(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def g_layers(size: int, ngf: int, n_blocks: int, cond_nc: int,
             in_nc: int = 3, out_nc: int = 3) -> List[int]:
    """FLOPs of each of G's layers for one image, in order."""
    s2, s4 = size // 2, size // 4
    t = 4 * ngf
    out = [2 * size * size * ngf * (in_nc + cond_nc) * 49,
           2 * s2 * s2 * 2 * ngf * ngf * 9,
           2 * s4 * s4 * t * 2 * ngf * 9]
    out += [2 * s4 * s4 * t * t * 9] * (2 * n_blocks)
    out += [2 * s4 * s4 * t * 2 * ngf * 9,          # transposed: input side
            2 * s2 * s2 * 2 * ngf * ngf * 9,
            2 * size * size * out_nc * ngf * 49]
    return out


def d_layers(size: int, ndf: int, cond_nc: int, n_layers: int = 3,
             in_nc: int = 3) -> List[int]:
    out, h, ch = [], size, in_nc + cond_nc
    for n in range(n_layers + 2):
        feats = (1 if n == n_layers + 1 else ndf * min(2 ** n, 8))
        stride = 2 if n < n_layers else 1
        h = _out(h, 4, stride, 1)
        out.append(2 * h * h * feats * ch * 16)
        ch = feats
    return out


def c_layers(size: int, nf: int, n_down: int, in_nc: int = 3) -> List[int]:
    out, h, ch = [], size, in_nc
    for i in range(n_down):
        feats = nf * min(2 ** i, 8)
        h = _out(h, 4, 2, 1)
        out.append(2 * h * h * feats * ch * 16)
        ch = feats
    return out + [2 * ch * 4 * nf, 2 * 4 * nf * 2]


def pass_flops(layers: List[int], n: int, backward: str = "") -> int:
    """One pass over ``n`` images: forward, plus ``backward`` 'weights'
    (weight and input gradients; the first layer's input needs none),
    'inputs' (input gradients only, every layer) or ''."""
    f = sum(layers) * n
    if backward == "weights":
        return f + f + f - layers[0] * n
    if backward == "inputs":
        return f + f
    return f


def train_step_flops(m: Dict, batch: int) -> int:
    """The fused step on ``batch`` rows: G's 2B forward and backward, D's
    update on 2B (real and pool fakes), and the G loss's D and comparator
    passes on the B fakes."""
    s = m["crop"]
    g = g_layers(s, m["ngf"], m["n_blocks"], m["n_bins"])
    d = d_layers(s, m["ndf"], m["n_bins"], m["n_layers_D"])
    total = (pass_flops(g, 2 * batch, "weights")
             + pass_flops(d, 2 * batch, "weights")
             + pass_flops(d, batch, "inputs"))
    if m.get("comparator"):
        total += pass_flops(c_layers(s, m["cmp_nf"], m["cmp_n_down"]),
                            batch, "inputs")
    return total


def grid_flops(m: Dict, faces: int) -> int:
    """G's forward at every bin for ``faces`` inputs."""
    g = g_layers(m["crop"], m["ngf"], m["n_blocks"], m["n_bins"])
    return pass_flops(g, faces * m["n_bins"])
