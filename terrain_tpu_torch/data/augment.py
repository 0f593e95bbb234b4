"""Paired data augmentation on the device, inside the train step
(terrain_tpu/data/augment.py).

The reference augments with flips on both axes and a rotation by
theta ~ U(-360, 360) degrees with 'reflect' fill, the same transform for a
heightmap and its texture.  Here A and B are concatenated on channels and
transformed together, so the pairing is exact by construction.  Rotation is
bilinear resampling with the edge-inclusive reflect boundary
(d c b a | a b c d | d c b a).

Two formulations, as in terrain_tpu, selected by TERRAIN_AUGMENT at call
time: 'shear' (default, square images) is the Paeth three-shear
factorization after a per-image quarter turn, three 1-D fractional shifts;
'gather' is the one-pass four-tap bilinear rotation, the semantic reference
in the tests.  The two agree in distribution, not pixel for pixel (three
2-tap mixes are smoother than one 4-tap mix).

Each function takes its angle and flips as arguments; `augment_pair` draws
them from an explicit `torch.Generator`.
"""

import math
import os

import torch


def _reflect_index(i, n):
    """Edge-inclusive reflect: ... 1 0 | 0 1 .. n-1 | n-1 n-2 ... (period 2n)."""
    m = torch.remainder(i, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def _per_image(v, n, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(-1).expand(n)


def _rotate_flip_gather(imgs, theta, flip_h, flip_v):
    """Batched one-pass rotation: each (H, W, C) image of imgs (N,H,W,C) is
    rotated by theta[n] (radians) about its centre with bilinear sampling
    and reflect fill, then flipped.  The flips are folded into the source
    coordinates (flipping the output negates the centred target grid), and
    the four taps are gathers over the flattened image."""
    n, h, w, c = imgs.shape
    dev = imgs.device
    theta = _per_image(theta, n, torch.float32, dev).reshape(n, 1, 1)
    flip_h = _per_image(flip_h, n, torch.bool, dev).reshape(n, 1, 1)
    flip_v = _per_image(flip_v, n, torch.bool, dev).reshape(n, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None]
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None, :]
    yy = torch.where(flip_v, -yy, yy).expand(n, h, w)
    xx = torch.where(flip_h, -xx, xx).expand(n, h, w)
    ct, st = torch.cos(theta), torch.sin(theta)
    u = ct * yy - st * xx + cy  # source row coordinate
    v = st * yy + ct * xx + cx  # source col coordinate
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u0i, v0i = u0.long(), v0.long()
    u1i, v1i = _reflect_index(u0i + 1, h), _reflect_index(v0i + 1, w)
    u0i, v0i = _reflect_index(u0i, h), _reflect_index(v0i, w)
    flat = imgs.reshape(n, h * w, c)

    def tap(ui, vi):
        lin = (ui * w + vi).reshape(n, h * w, 1).expand(n, h * w, c)
        return torch.gather(flat, 1, lin).reshape(n, h, w, c)

    return (tap(u0i, v0i) * (1 - fu) * (1 - fv)
            + tap(u0i, v1i) * (1 - fu) * fv
            + tap(u1i, v0i) * fu * (1 - fv)
            + tap(u1i, v1i) * fu * fv)


def _rotate_flip_one(img, theta, flip_h, flip_v):
    """One (H, W, C) image through `_rotate_flip_gather`."""
    return _rotate_flip_gather(img[None], theta, flip_h, flip_v)[0]


def _shift_frac(x, t, axis):
    """Sample x at (index + t) along `axis` (1 or 2) of (N,H,W,C) images
    under the reflect boundary: out[j] = (1-f)*x[j+k] + f*x[j+k+1] with
    k = floor(t), f = frac(t).  t: per-image-per-row offsets, broadcastable
    against x with size 1 on `axis` and on C.

    terrain_tpu rolls the reflect extension concat(x, reverse(x)) by the
    bits of k and crops; one period of that extension IS the reflect index,
    so a gather along the axis with reflect(j + k) reads the same elements,
    and the two-tap mix is the same arithmetic."""
    n, h, w, c = x.shape
    length = x.shape[axis]
    k = torch.floor(t)
    f = t - k
    j = torch.arange(length, device=x.device)
    j = j.reshape(1, -1, 1, 1) if axis == 1 else j.reshape(1, 1, -1, 1)
    i0 = j + k.long()
    x0 = torch.gather(x, axis, _reflect_index(i0, length).expand(n, h, w, c))
    x1 = torch.gather(x, axis,
                      _reflect_index(i0 + 1, length).expand(n, h, w, c))
    return x0 * (1.0 - f) + x1 * f


def _rot90_select(x, q):
    """Per-image rot90**q for square (N, H, W, C) images, q: (N,) in 0..3,
    in `_rotate_flip_gather`'s sampling convention out[p] = src[R(q*90) p]:
    for q=1, out[i,j] = src[h-1-j, i]."""
    r1 = x.transpose(1, 2).flip(2)   # 90
    r2 = x.flip(1).flip(2)           # 180
    r3 = x.transpose(1, 2).flip(1)   # 270
    q = q.reshape(-1, 1, 1, 1)
    return torch.where(q == 0, x,
                       torch.where(q == 1, r1, torch.where(q == 2, r2, r3)))


def _rotate_flip_shear(imgs, theta, flip_h, flip_v):
    """Batched rotate+flip, equal in distribution to `_rotate_flip_gather`.
    imgs: (N, H, W, C) square images; theta: (N,) radians."""
    n, h, w, c = imgs.shape
    if h != w:
        raise ValueError("shear rotation assumes square images")
    dev = imgs.device
    theta = _per_image(theta, n, torch.float32, dev)
    flip_h = _per_image(flip_h, n, torch.bool, dev)
    flip_v = _per_image(flip_v, n, torch.bool, dev)
    # reduce to |r| <= pi/4 with a per-image quarter-turn pre-rotation
    theta = torch.remainder(theta, 2 * math.pi)
    q = torch.floor((theta + math.pi / 4) / (math.pi / 2)).to(torch.int32)
    r = theta - q.float() * (math.pi / 2)
    x = _rot90_select(imgs, torch.remainder(q, 4))

    # sampling composition out(p) = src(Xa.Yb.Xa.p) equals src(R(r).p)
    # with a = tan(r/2), b = -sin(r)
    a = torch.tan(r / 2.0)
    b = -torch.sin(r)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=dev) - cy
    cols = torch.arange(w, dtype=torch.float32, device=dev) - cx
    # x-shear: out[i, j] = src[i, j + a*(i-cy)]
    t1 = (a[:, None] * rows[None, :])[:, :, None, None]   # (N, H, 1, 1)
    # y-shear: out[i, j] = src[i + b*(j-cx), j]
    t2 = (b[:, None] * cols[None, :])[:, None, :, None]   # (N, 1, W, 1)
    x = _shift_frac(x, t1, axis=2)
    x = _shift_frac(x, t2, axis=1)
    x = _shift_frac(x, t1, axis=2)

    x = torch.where(flip_h.reshape(-1, 1, 1, 1), x.flip(2), x)
    x = torch.where(flip_v.reshape(-1, 1, 1, 1), x.flip(1), x)
    return x


def augment_pair(generator, X, Y, *, rotation=True, flips=True):
    """One random transform per (A, B) pair; A (N,H,W,Ca), B (N,H,W,Cb).
    theta ~ U(-2pi, 2pi) and the two flips (p = 0.5 each) are drawn from
    `generator`, on its device.  Returns (X_aug, Y_aug)."""
    n, ca = X.shape[0], X.shape[-1]
    dev = X.device

    def draw():
        return torch.rand(n, generator=generator,
                          device=generator.device).to(dev)

    if rotation:
        theta = draw() * (4 * math.pi) - 2 * math.pi
    else:
        theta = torch.zeros(n, device=dev)
    if flips:
        flip_h, flip_v = draw() < 0.5, draw() < 0.5
    else:
        flip_h = flip_v = torch.zeros(n, dtype=torch.bool, device=dev)
    both = torch.cat([X, Y], dim=-1)
    if not rotation:
        out = torch.where(flip_h.reshape(-1, 1, 1, 1), both.flip(2), both)
        out = torch.where(flip_v.reshape(-1, 1, 1, 1), out.flip(1), out)
    elif (os.environ.get("TERRAIN_AUGMENT", "shear") == "shear"
            and X.shape[1] == X.shape[2]):
        out = _rotate_flip_shear(both, theta, flip_h, flip_v)
    else:
        out = _rotate_flip_gather(both, theta, flip_h, flip_v)
    return out[..., :ca], out[..., ca:]
