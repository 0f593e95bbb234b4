"""Terrain-domain realism metrics (terrain_tpu/eval/terrain.py): the
Wasserstein-1 distance between the real and the generated elevation
distributions (`elev_w1`, a hypsometric-curve mismatch) and between their
slope distributions (`slope_w1`, gradient magnitude by central differences
at unit spacing).  Both are exact quantile couplings of equal-size samples
(sort + mean abs diff), computed where the images are, with one fetch.

The two sets share their random sample indices (common random numbers, so
identical sets score exactly 0).  The indices come from `terrain_draws`, a
`torch.Generator` on the host seeded by `seed`; the tests replace that one
function with terrain_tpu's threefry draws.
"""

import torch


def _slope(x):
    """Gradient magnitude via central differences, (N,H,W,C) -> flat."""
    dy = (x[:, 2:, 1:-1, :] - x[:, :-2, 1:-1, :]) * 0.5
    dx = (x[:, 1:-1, 2:, :] - x[:, 1:-1, :-2, :]) * 0.5
    return torch.sqrt(dx * dx + dy * dy).reshape(-1)


def terrain_draws(seed, n_elev, n_slope, n_sample):
    """Sample indices into the flat elevations and slopes, int64, on the
    host, from one generator seeded by `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    ei = torch.randint(0, n_elev, (n_sample,), generator=g)
    si = torch.randint(0, n_slope, (n_sample,), generator=g)
    return ei, si


def terrain_stats(real, fake, seed=0, n_sample=65536):
    """Dict of terrain-realism W1 scores for heightmap batches of one shape
    (N, H, W, C), in the same value range."""
    if tuple(real.shape) != tuple(fake.shape):
        raise ValueError(f"terrain_stats: shapes {tuple(real.shape)} and "
                         f"{tuple(fake.shape)} differ")
    n, h, w, c = real.shape
    ei, si = terrain_draws(seed, n * h * w * c, n * (h - 2) * (w - 2) * c,
                           n_sample)
    ei, si = ei.to(real.device), si.to(real.device)

    def descriptors(x):
        x = x.float()
        return (torch.sort(x.reshape(-1)[ei]).values,
                torch.sort(_slope(x)[si]).values)

    elev_r, slope_r = descriptors(real)
    elev_f, slope_f = descriptors(fake)
    e, s = torch.stack([(elev_r - elev_f).abs().mean(),
                        (slope_r - slope_f).abs().mean()]).tolist()
    return {"elev_w1": e, "slope_w1": s}
