"""Synthetic rotating-LiDAR scans, made on the device from a generator (the
benchmark's frozen copy of the port's `data/lidar_sim.py`, batched over
scans and drawn with torch instead of numpy).

Beams on `n_rings` elevation rings x 1 degree azimuth columns, ring ranges
2..80 m with near-field densification; a smooth ground surface per scan,
sampled per (azimuth bin, ring); ~100 vertical structures of 1-6 m taking
9% of the points; sub-voxel jitter, ranges and heights snapped to voxel
centres (0.3 m, 0.2 m), so ~65k points fill ~16k polar voxels of EgoNN's
(1 deg, 0.3 m, 0.2 m) grid.  Azimuths are uniform within their bin.
"""
from __future__ import annotations

import math

import torch

N_RINGS, N_POLE_CELLS, POLE_FRACTION = 38, 100, 0.09
R_STEP, Z_STEP, N_AZ = 0.3, 0.2, 360


def lidar_scans(b: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """(b, n, 3) float32 cartesian scans on the generator's device."""
    dev = gen.device
    f64 = torch.float64

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    rings = torch.arange(N_RINGS, device=dev, dtype=f64)
    ring_r = 2.0 + 78.0 * (rings / (N_RINGS - 1)) ** 1.7
    ring_r = (torch.floor(ring_r / R_STEP) + 0.5) * R_STEP
    deg = math.pi / 180.0
    n_pole = int(POLE_FRACTION * n)
    n_surf = n - n_pole

    phase = rand(b, 6, 1) * (2 * math.pi)
    amp = 0.3 + 0.9 * rand(b, 6, 1)
    km = torch.tensor([1, 2, 3, 5, 7, 11], device=dev, dtype=f64)[None, :, None]
    tb = randint(N_AZ, b, n_surf)
    rg = randint(N_RINGS, b, n_surf)
    ground = (amp * torch.sin(km * ((tb + 0.5) * deg)[:, None, :] + phase)).sum(1)
    ground = ground * (0.3 + 0.7 * ring_r[rg] / 80.0)
    gz = (torch.floor(ground / Z_STEP) + 0.5) * Z_STEP
    theta = (tb + rand(b, n_surf)) * deg
    r = ring_r[rg] + (rand(b, n_surf) - 0.5) * (R_STEP * 0.6)
    z = gz + (rand(b, n_surf) - 0.5) * (Z_STEP * 0.6)

    pt = randint(N_AZ, b, N_POLE_CELLS)
    pr = randint(N_RINGS, b, N_POLE_CELLS)
    height = 1.0 + 5.0 * rand(b, N_POLE_CELLS)
    pj = randint(N_POLE_CELLS, b, n_pole)
    theta_p = (torch.gather(pt, 1, pj) + rand(b, n_pole)) * deg
    r_p = ring_r[torch.gather(pr, 1, pj)] + (rand(b, n_pole) - 0.5) * (R_STEP * 0.6)
    z_p = ((torch.floor(rand(b, n_pole) * torch.gather(height, 1, pj) / Z_STEP) + 0.5) * Z_STEP
           + (rand(b, n_pole) - 0.5) * (Z_STEP * 0.6))

    th = torch.cat([theta, theta_p], 1)
    rr = torch.cat([r, r_p], 1).clamp(2.0, 80.0)
    zz = torch.cat([z, z_p], 1)
    return torch.stack([rr * torch.cos(th), rr * torch.sin(th), zz], -1).to(torch.float32)


def generator(device, *words: int) -> torch.Generator:
    """A generator on `device` seeded from the words (seed, purpose, ...):
    any seed up to 2**63 gives its own stream."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3 & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return torch.Generator(device=device).manual_seed(h & 0x7FFFFFFFFFFFFFFF)
