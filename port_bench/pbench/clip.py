"""Seeded synthetic content, made on the device in a few large calls.

One generator for every traffic mix: the mix's ``content`` block gives the
pattern's parameters, the configuration gives the geometry, and the seed
gives the phases and the noise.  Every seed gets the same amplitudes,
motion and noise level, so a seed changes the pictures and not the amount
of work.  The pattern is the one of the repository's ``bench.py`` clip (two
moving sinusoids in luma plus uniform noise, slow sinusoids in chroma),
with seeded phases.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def make_frames(n: int, width: int, height: int, content: dict, seed: int,
                device) -> list:
    """``n`` frames of ``width`` x ``height`` 8-bit 4:2:0 content as a list
    of (y, u, v) numpy uint8 planes (views of three contiguous arrays)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    f32 = dict(dtype=torch.float32, device=device)
    phase = torch.rand(5, generator=g, **f32) * (2 * math.pi)
    t = torch.arange(n, **f32)[:, None, None]
    xx = torch.arange(width, **f32)[None, None, :]
    yy = torch.arange(height, **f32)[None, :, None]
    c = content
    y = (c["luma_mean"]
         + c["amp_x"] * torch.sin(xx / c["period_x"] + t * c["motion_x"]
                                  + phase[0])
         + c["amp_y"] * torch.cos(yy / c["period_y"] + t * c["motion_y"]
                                  + phase[1]))
    k = int(c["noise"])
    y = y + torch.randint(-k, k + 1, (n, height, width), generator=g,
                          device=device, dtype=torch.int16).float()
    ch, cw = (height + 1) // 2, (width + 1) // 2
    cx = torch.arange(cw, **f32)[None, None, :] * 2
    cy = torch.arange(ch, **f32)[None, :, None] * 2
    u = 128 + c["amp_chroma"] * torch.sin(cx / c["period_u"]
                                          + t * c["motion_u"] + phase[2])
    v = 128 + c["amp_chroma"] * torch.cos(cy / c["period_v"] + phase[3])
    u = u.expand(n, ch, cw)
    v = v.expand(n, ch, cw)
    planes = [p.clamp(0, 255).round_().to(torch.uint8).cpu().numpy()
              for p in (y, u, v)]
    return [(planes[0][i], planes[1][i], planes[2][i]) for i in range(n)]
