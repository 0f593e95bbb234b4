"""OpenCV's read of a raster, as imageio's OpenCV plugin makes it.

The JAX package reads its rasters with `imageio.v3.imread`, which picks a
plugin for a path by its extension (`READERS`, from imageio/config/
extensions.py), then tries every plugin, Pillow first, then OpenCV; bytes
have no extension, so Pillow reads them where it can open them and OpenCV
where it cannot (`reader`).  So OpenCV reads a *.pbm, *.pfm, *.hdr, *.pic
or *.sr path, and PF, P7 or Radiance bytes at any path or none
(imageio/plugins/opencv.py).  That plugin asks OpenCV for one image
under IMREAD_COLOR, then turns BGR into RGB and BGRA into RGBA and leaves a
gray image 2-D.  IMREAD_COLOR asks for 8-bit samples: a decoder of floats
hands them to `Mat::convertTo`, which rounds half to even and saturates
(`saturate_cast<uchar>`, through `cvRound`, so a value that does not fit
an int32 -- a NaN, an infinity, 2^31 -- gives INT_MIN and then 0).  The decoders themselves (data/pnm.py's
PFM and PAM, data/hdr.py, data/sun.py) give the samples in OpenCV's
channel order; this module holds no decoder.
"""

import os

import numpy as np

# imageio's plugins for a path, by its extension, before it tries them all
# (imageio/config/extensions.py:193, 344, 642-719, 755, 760, 968; the ones
# not installed beside the JAX package -- FreeImage, ITK, pyav -- left out)
READERS = {".pbm": ("opencv", "pillow"), ".pfm": ("opencv",),
           ".pgm": ("pillow", "opencv"), ".ppm": ("pillow", "opencv"),
           ".pnm": ("pillow", "opencv"), ".pam": (), ".pxm": ("opencv",),
           ".hdr": ("opencv",), ".pic": ("opencv",), ".sr": ("opencv",),
           ".ras": ("pillow", "opencv"), ".dds": ("pillow",)}
_INT_LIMIT = np.float32(2.0 ** 31)


def reader(path, pillow, opencv=True):
    """The plugin imageio reads a file with: "pillow" or "opencv", or None
    where neither opens it.  `path` None for bytes; `pillow` / `opencv`:
    whether that library opens the file (Pillow: one of its plugins takes
    the header; OpenCV: a decoder takes the signature)."""
    ext = os.path.splitext(path)[1].lower() if path is not None else None
    opens = {"pillow": pillow, "opencv": opencv}
    for name in READERS.get(ext, ()) + ("pillow", "opencv"):
        if opens[name]:
            return name
    return None


def check_size(w, h, what):
    """OpenCV's validateInputImageSize: ValueError for a side past 2^20 or
    more than 2^30 pixels (or none)."""
    if not (0 < w <= 1 << 20 and 0 < h <= 1 << 20 and w * h <= 1 << 30):
        raise ValueError(f"{what}: OpenCV does not read a {w}x{h} image")


def to_u8(v, scale=None):
    """float32 samples (times `scale`, a float32 product, where given) to
    the uint8 that OpenCV's convertTo gives."""
    v = np.asarray(v, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        if scale is not None:
            v = v * np.float32(scale)
        fits = (v < _INT_LIMIT) & (v >= -_INT_LIMIT)
        r = np.rint(np.where(fits, v, 0))
    return np.clip(r, 0, 255).astype(np.uint8)


def colour(img):
    """OpenCV's BGR (or BGRA) image, or a gray 2-D one, as imageio's OpenCV
    plugin returns it."""
    img = np.asarray(img)
    if img.ndim == 2:
        return np.ascontiguousarray(img)
    order = [2, 1, 0, 3][:img.shape[-1]]
    return np.ascontiguousarray(img[..., order])
