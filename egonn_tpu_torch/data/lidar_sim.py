"""Synthetic rotating-LiDAR scans with realistic voxel occupancy (a numpy-only
copy of `egonn_tpu/data/lidar_sim.py`, which the port may not import).

Returns concentrate on surfaces, so ~65k points land in ~16k polar voxels
(1 deg, 0.3 m, 0.2 m).  The generator mimics the structure that produces such
occupancy:

* beams on `n_rings` elevation rings x 1deg azimuth columns, ring ranges
  spread 2..80 m with near-field densification (spacing ~ (i/n)^1.7);
* a smooth per-scan ground surface z(theta, ring) (low-frequency sinusoids,
  gentler near the sensor) sampled per (azimuth-bin, ring) cell;
* sparse vertical structures (poles/walls: ~100 cells with 1-6 m extent)
  taking ~9% of the points;
* sub-voxel jitter, with beam ranges and surface heights snapped to voxel
  centres so a beam cell is one voxel, not a straddled pair.

At 8 x 65,536 points every level fits the default EgoNN capacity table
(cap0 = 16384) without drops.
"""
from __future__ import annotations

import numpy as np


def lidar_scan_clouds(b: int, n: int, seed: int = 0, n_rings: int = 38,
                      n_pole_cells: int = 100, pole_point_frac: float = 0.09,
                      theta_step_deg: float = 1.0, r_step: float = 0.3,
                      z_step: float = 0.2) -> np.ndarray:
    """(b, n, 3) float32 cartesian clouds; see module docstring."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, n, 3), np.float32)
    n_az = int(round(360.0 / theta_step_deg))
    ring_r_raw = 2.0 + 78.0 * (np.arange(n_rings) / (n_rings - 1)) ** 1.7
    ring_r = (np.floor(ring_r_raw / r_step) + 0.5) * r_step  # voxel centres
    deg = np.pi / 180.0 * theta_step_deg
    for i in range(b):
        # smooth per-scan ground surface over (theta, ring)
        ph = rng.uniform(0, 2 * np.pi, 6)
        amp = rng.uniform(0.3, 1.2, 6)
        km = np.array([1, 2, 3, 5, 7, 11])
        n_pole_pts = int(pole_point_frac * n)
        n_surf = n - n_pole_pts

        tb = rng.integers(0, n_az, n_surf)          # azimuth bin per point
        rg = rng.integers(0, n_rings, n_surf)       # ring per point
        theta_c = (tb + 0.5) * deg                  # terrain at the bin centre
        ground = sum(a * np.sin(k * theta_c + p)
                     for a, k, p in zip(amp, km, ph))
        ground = ground * (0.3 + 0.7 * ring_r[rg] / 80.0)
        gz = (np.floor(ground / z_step) + 0.5) * z_step
        theta = (tb + rng.random(n_surf)) * deg
        r = ring_r[rg] + (rng.random(n_surf) - 0.5) * (r_step * 0.6)
        z = gz + (rng.random(n_surf) - 0.5) * (z_step * 0.6)

        # vertical structures: a few cells with 1-6 m extents
        pt = rng.integers(0, n_az, n_pole_cells)
        pr = rng.integers(0, n_rings, n_pole_cells)
        p_h = rng.uniform(1.0, 6.0, n_pole_cells)
        pj = rng.integers(0, n_pole_cells, n_pole_pts)
        theta_p = (pt[pj] + rng.random(n_pole_pts)) * deg
        r_p = ring_r[pr[pj]] + (rng.random(n_pole_pts) - 0.5) * (r_step * 0.6)
        z_p = ((np.floor(rng.random(n_pole_pts) * p_h[pj] / z_step) + 0.5)
               * z_step + (rng.random(n_pole_pts) - 0.5) * (z_step * 0.6))

        th = np.concatenate([theta, theta_p])
        rr = np.concatenate([r, r_p]).clip(2.0, 80.0)
        zz = np.concatenate([z, z_p])
        out[i] = np.stack([rr * np.cos(th), rr * np.sin(th), zz],
                          -1).astype(np.float32)
    return out
