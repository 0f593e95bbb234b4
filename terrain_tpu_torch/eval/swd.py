"""Sample-quality metric without pretrained networks
(terrain_tpu/eval/swd.py): the Sliced Wasserstein Distance over a Laplacian
pyramid of patch descriptors (the ProGAN protocol, Karras et al. 2018).
Lower is better; identical sets score ~0.

Everything runs where the images are, as one pass: the pyramid, the patch
gathers, the projections and the sorts are device work, and the only fetch
is the final values.  Two details match jax.image.resize and jnp:
  * the 2x downsample is antialiased (jax.image.resize's bilinear scales its
    triangle kernel when it shrinks), so `F.interpolate(antialias=True)`;
  * the descriptors' standard deviation is the population one
    (`correction=0`, as jnp.std).

The random numbers (patch positions, projection directions) cannot be
threefry's.  They come from `swd_draws`, a `torch.Generator` on the host
seeded by `seed`, so the card and the CPU draw the same ones; the tests
replace that one function with the JAX draws.  As in terrain_tpu, the real
and the generated set share the patch positions of a level, and every
level draws anew.
"""

import torch
import torch.nn.functional as F


def _resize(x, h, w, antialias=False):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


def laplacian_pyramid(x, n_levels):
    """List of n_levels band-pass images + the final low-pass residual."""
    levels = []
    cur = x
    for _ in range(n_levels):
        n, h, w, c = cur.shape
        down = _resize(cur, h // 2, w // 2, antialias=True)
        levels.append(cur - _resize(down, 2 * (h // 2), 2 * (w // 2)))
        cur = down
    levels.append(cur)
    return levels


def extract_patches(x, ys, xs, patch=7):
    """Patch descriptors at the given top-left corners, channel-normalized:
    x (N,H,W,C), ys and xs (N, n) -> (N*n, patch*patch*C)."""
    n, c = x.shape[0], x.shape[3]
    d = torch.arange(patch, device=x.device)
    rows = (ys.to(x.device)[:, :, None] + d)[:, :, :, None]   # (N,n,p,1)
    cols = (xs.to(x.device)[:, :, None] + d)[:, :, None, :]   # (N,n,1,p)
    img = torch.arange(n, device=x.device)[:, None, None, None]
    desc = x[img, rows, cols].reshape(-1, patch * patch * c)  # (N,n,p,p,C)
    mu = desc.mean(dim=0, keepdim=True)
    sd = desc.std(dim=0, keepdim=True, correction=0) + 1e-8
    return (desc - mu) / sd


def sliced_wasserstein(a, b, proj):
    """SWD between point sets a (n, d) and b (m, d) along the columns of
    proj (d, n_proj), each normalized to unit length."""
    proj = proj.to(a.device)
    proj = proj / (torch.linalg.norm(proj, dim=0, keepdim=True) + 1e-8)
    pa = torch.sort(a @ proj, dim=0).values
    pb = torch.sort(b @ proj, dim=0).values
    m = min(pa.shape[0], pb.shape[0])
    return (pa[:m] - pb[:m]).abs().mean()


def swd_draws(seed, level_shapes, patch, n_per_img, n_proj):
    """The random numbers of `swd_pyramid`, per pyramid level of shape
    (N, H, W, C): patch corners ys, xs (N, n_per_img), int64, and
    projections (patch*patch*C, n_proj), fp32 -- on the host, from one
    generator seeded by `seed`."""
    g = torch.Generator().manual_seed(int(seed))
    out = []
    for n, h, w, c in level_shapes:
        ys = torch.randint(0, h - patch + 1, (n, n_per_img), generator=g)
        xs = torch.randint(0, w - patch + 1, (n, n_per_img), generator=g)
        proj = torch.randn(patch * patch * c, n_proj, generator=g)
        out.append((ys, xs, proj))
    return out


def swd_pyramid(real, fake, seed=0, n_levels=3, patch=7, n_per_img=64,
                n_proj=128):
    """Per-level SWD dict + mean.  real and fake: (N, H, W, C) tensors of one
    shape, on one device, in the same value range (heightmaps in [0,1] or
    textures in [-1,1])."""
    if tuple(real.shape) != tuple(fake.shape):
        raise ValueError(f"swd_pyramid: shapes {tuple(real.shape)} and "
                         f"{tuple(fake.shape)} differ")
    real_p = laplacian_pyramid(real.float(), n_levels)
    fake_p = laplacian_pyramid(fake.float(), n_levels)
    draws = swd_draws(seed, [tuple(r.shape) for r in real_p], patch,
                      n_per_img, n_proj)
    # the projections are fp32 matmuls, never TF32: the flag that
    # device.strict_fp32 sets for a whole run, here for this call only
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        vals = torch.stack([
            sliced_wasserstein(extract_patches(r, ys, xs, patch),
                               extract_patches(f, ys, xs, patch), proj)
            for r, f, (ys, xs, proj) in zip(real_p, fake_p, draws)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    v = torch.cat([vals, vals.mean()[None]]).tolist()  # the one fetch
    out = {f"swd_level{lvl}": v[lvl] for lvl in range(len(real_p))}
    out["swd_mean"] = v[-1]
    return out
