"""The reference family's generators as plain torch modules (the port's own
copy of ``ResnetG``, ``ResBlock``, ``UnetBlock`` and ``build_unet`` from
``benchmarks/torch_baseline.py``, which the port does not import).

Their ``state_dict`` names and registration order are the pix2pix-template
layout of a reference ``.pth``: ``tools/export_pth.py`` takes them as the
template when no ``--like`` file is given, and the tests hold this copy's
keys and shapes against the original. They take and return NCHW, with the
condition map concatenated to the input by the caller (input injection).
"""

from __future__ import annotations

import torch
import torch.nn as nn


class ResBlock(nn.Module):
    def __init__(self, dim, norm=nn.InstanceNorm2d, bias=True):
        super().__init__()
        self.block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
            norm(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3, bias=bias),
            norm(dim))

    def forward(self, x):
        return x + self.block(x)


class ResnetG(nn.Module):
    """The resnet generator. ``cond_inject='input'``: the caller concats
    the condition map to x and the net is one Sequential.
    ``'bottleneck'``: the stem takes bare x; after the downsampling convs a
    1x1 projection consumes [features; cond map]."""

    def __init__(self, in_nc, out_nc, ngf=64, n_blocks=9, batchnorm=False,
                 cond_nc=0, cond_inject="input"):
        super().__init__()
        norm = nn.BatchNorm2d if batchnorm else nn.InstanceNorm2d
        bias = not batchnorm          # no conv bias under affine batch norm
        head = [nn.ReflectionPad2d(3), nn.Conv2d(in_nc, ngf, 7, bias=bias),
                norm(ngf), nn.ReLU(True),
                nn.Conv2d(ngf, ngf * 2, 3, 2, 1, bias=bias), norm(ngf * 2),
                nn.ReLU(True),
                nn.Conv2d(ngf * 2, ngf * 4, 3, 2, 1, bias=bias),
                norm(ngf * 4), nn.ReLU(True)]
        tail = [ResBlock(ngf * 4, norm, bias) for _ in range(n_blocks)]
        tail += [nn.ConvTranspose2d(ngf * 4, ngf * 2, 3, 2, 1, 1, bias=bias),
                 norm(ngf * 2), nn.ReLU(True),
                 nn.ConvTranspose2d(ngf * 2, ngf, 3, 2, 1, 1, bias=bias),
                 norm(ngf), nn.ReLU(True),
                 nn.ReflectionPad2d(3), nn.Conv2d(ngf, out_nc, 7),
                 nn.Tanh()]
        self.bottleneck_cond = cond_inject == "bottleneck"
        if self.bottleneck_cond:
            self.net = nn.Sequential(*head)
            self.proj = nn.Conv2d(ngf * 4 + cond_nc, ngf * 4, 1, bias=bias)
            self.tail = nn.Sequential(*tail)
        else:
            self.net = nn.Sequential(*(head + tail))

    def forward(self, x, cond=None):
        if not self.bottleneck_cond:
            return self.net(x)
        h = self.net(x)
        cmap = cond[:, :, None, None].expand(-1, -1, h.shape[2], h.shape[3])
        return self.tail(self.proj(torch.cat([h, cmap], 1)))


class UnetBlock(nn.Module):
    """A pix2pix-template recursive U-Net block."""

    def __init__(self, outer_nc, inner_nc, input_nc=None, submodule=None,
                 outermost=False, innermost=False):
        super().__init__()
        self.outermost = outermost
        if input_nc is None:
            input_nc = outer_nc
        downconv = nn.Conv2d(input_nc, inner_nc, 4, 2, 1)
        downrelu = nn.LeakyReLU(0.2, True)
        downnorm = nn.InstanceNorm2d(inner_nc)
        uprelu = nn.ReLU(True)
        upnorm = nn.InstanceNorm2d(outer_nc)
        if outermost:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            model = [downconv] + ([submodule] if submodule else []) \
                + [uprelu, upconv, nn.Tanh()]
        elif innermost:
            upconv = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1)
            model = [downrelu, downconv, uprelu, upconv, upnorm]
        else:
            upconv = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            model = [downrelu, downconv, downnorm, submodule, uprelu, upconv,
                     upnorm]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


def build_unet(input_nc, output_nc, num_downs, ngf=64):
    blk = UnetBlock(ngf * 8, ngf * 8, innermost=True)
    for _ in range(num_downs - 5):
        blk = UnetBlock(ngf * 8, ngf * 8, submodule=blk)
    blk = UnetBlock(ngf * 4, ngf * 8, submodule=blk)
    blk = UnetBlock(ngf * 2, ngf * 4, submodule=blk)
    blk = UnetBlock(ngf, ngf * 2, submodule=blk)
    return UnetBlock(output_nc, ngf, input_nc=input_nc, submodule=blk,
                     outermost=True)
