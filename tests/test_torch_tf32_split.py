"""The numerical design of csrc/bilinear_conv.cu and of the stem's forward
(csrc/conv_stem.cu), emulated on the CPU, and the bound chip_smoke.py
reckons for them (terrain_tpu_torch/utils/roofline.py).

The kernel multiplies the upsampled tile u and the weights w on the TF32
tensor cores.  One TF32 pass rounds both factors to 11 significant bits, so
the kernel splits each fp32 factor into two TF32 parts, v = v_hi + v_lo,
each rounded to nearest with ties away from zero as cvt.rna.tf32.f32 does,
and sums u_lo*w_hi + u_hi*w_lo + u_hi*w_hi (3xTF32); bf16 weights are exact
in TF32, so bf16 inputs take u_lo*w + u_hi*w.  Here the same split runs in
PyTorch (products of TF32 parts are exact in fp32, sums in fp32) at the full
channel widths of both flagship decoder stages, and is held to an fp64
reference within 1e-4 x max|ref|, the kernel's fp32 tolerance on the card.
Other cases show why the kernel splits and needs every product: a single
TF32 pass misses the tolerance, in fp32 and in bf16, and so does the split
without either cross term.

The tensor cores' own accumulation (alignment to the largest addend, with
truncation) is not emulated: on the card it adds ~3e-5 x max|ref| at K =
9*512 (PERF.md), inside the same tolerance.  The CUDA kernel itself runs
only on the card, where chip_smoke.py holds it against its plain version and
terrain_tpu_torch/tools/bilinear_conv_variants.py builds the same variants
there.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4  # x max|ref|: chip_smoke.py's F32_TOL


def tf32_rna(v):
    """Round fp32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, by bit masking: add half a unit of the 13 bits that go,
    then clear them (the sign bit rides along, so this acts on the
    magnitude)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(v):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def im2col_upsampled(x):
    """x (N,H,W,C) -> the conv's K x pixels matrix of the bilinear x2 tile,
    K ordered (c, dy, dx), in x's float type."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    return F.unfold(up, 3, padding=1)[0]          # (C*9, 4HW)


def weight_rows(w):
    """w (3,3,C,F) HWIO -> (F, C*9), K ordered as im2col_upsampled."""
    return w.permute(3, 2, 0, 1).reshape(w.shape[3], -1)


def emulate(x, w, terms):
    """The kernel's sum: u from x in fp32, the named TF32 products summed in
    fp32, the small terms first.  terms: a subset of "lh" (u_lo*w_hi), "hl"
    (u_hi*w_lo) and "hh" (u_hi*w_hi); the kernel takes all three in fp32
    and "lh", "hh" in bf16, whose w_lo is zero."""
    u_hi, u_lo = split(im2col_upsampled(x.float()))
    w_hi, w_lo = split(weight_rows(w.float()))
    parts = {"lh": (w_hi, u_lo), "hl": (w_lo, u_hi), "hh": (w_hi, u_hi)}
    out = torch.zeros(w.shape[3], u_hi.shape[1], dtype=torch.float32)
    for t in terms:
        a, b = parts[t]
        out += a @ b
    return out


@pytest.mark.parametrize("dtype,shape,terms,agrees", [
    ("float32", (1, 8, 8, 512, 128), ("lh", "hl", "hh"), True),
    ("float32", (1, 16, 16, 256, 64), ("lh", "hl", "hh"), True),
    ("bfloat16", (1, 8, 8, 512, 128), ("lh", "hh"), True),
    ("bfloat16", (1, 16, 16, 256, 64), ("lh", "hh"), True),
    # why the kernel splits: one TF32 pass is ~2-3x over the tolerance
    ("float32", (1, 8, 8, 512, 128), ("hh",), False),
    # and why it needs every product: either cross term alone misses it
    ("float32", (1, 8, 8, 512, 128), ("hl", "hh"), False),
    ("float32", (1, 16, 16, 256, 64), ("lh", "hh"), False),
    # bf16 too: u is interpolated in fp32, so one pass (u_hi*w) misses it
    ("bfloat16", (1, 8, 8, 512, 128), ("hh",), False),
    ("bfloat16", (1, 16, 16, 256, 64), ("hh",), False),
], ids=["f32-3xTF32-64x512", "f32-3xTF32-128x256", "bf16-2xTF32-64x512",
        "bf16-2xTF32-128x256", "f32-one-TF32-pass", "f32-without-ulo-whi",
        "f32-without-uhi-wlo", "bf16-one-TF32-pass-64x512",
        "bf16-one-TF32-pass-128x256"])
def test_tf32_split_is_fp32_accurate(dtype, shape, terms, agrees):
    n, h, w, c, f = shape
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    wt = torch.from_numpy(
        (rng.randn(3, 3, c, f) * (9 * c) ** -0.5).astype(np.float32))
    if dtype == "bfloat16":  # the kernel's inputs, rounded as the caller's
        x, wt = x.bfloat16(), wt.bfloat16()
        # a bf16 weight is exact in TF32: its lo part is zero
        assert torch.equal(tf32_rna(wt.float()), wt.float())
    got = emulate(x, wt, terms)
    ref = weight_rows(wt.double()) @ im2col_upsampled(x.double())
    err = (got.double() - ref).abs().max().item()
    lim = TOL * ref.abs().max().item()
    assert (err <= lim) == agrees, (err / ref.abs().max().item(), TOL)


def stem_patches(x):
    """x (N,H,W,1) -> the stem conv's (N, 25 taps, pixels) patches."""
    return F.unfold(x.permute(0, 3, 1, 2), 5, padding=2)


@pytest.mark.parametrize("dtype,terms,agrees", [
    ("float32", ("lh", "hl", "hh"), True),
    # bf16 x and w are exact in TF32: one pass is exact
    ("bfloat16", ("hh",), True),
    ("float32", ("hh",), False),
    ("float32", ("hl", "hh"), False),
    ("float32", ("lh", "hh"), False),
], ids=["f32-3xTF32", "bf16-one-pass", "f32-one-TF32-pass",
        "f32-without-xlo-whi", "f32-without-xhi-wlo"])
def test_stem_forward_tf32_split_is_fp32_accurate(dtype, terms, agrees):
    """csrc/conv_stem.cu's forward takes the same split at K = 25 (the 5x5
    patches of one channel against w (25, F)), on the chip_smoke inputs'
    scales: the split lies ~2e-7 x max|ref| from fp64, one pass ~3e-4 and
    either cross term dropped ~2e-4, against the 1e-4 tolerance."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 48, 64, 1).astype(np.float32))
    w = torch.from_numpy((rng.randn(5, 5, 1, 64) * 0.2).astype(np.float32))
    if dtype == "bfloat16":
        x, w = x.bfloat16().float(), w.bfloat16().float()
        assert torch.equal(tf32_rna(x), x) and torch.equal(tf32_rna(w), w)
    x_hi, x_lo = split(stem_patches(x))
    w_hi, w_lo = split(w.reshape(25, 64))
    parts = {"lh": (x_lo, w_hi), "hl": (x_hi, w_lo), "hh": (x_hi, w_hi)}
    got = torch.zeros(2, x.shape[1] * x.shape[2], 64)
    for t in terms:
        a, b = parts[t]
        got += torch.einsum("nkp,kf->npf", a, b)
    ref = torch.einsum("nkp,kf->npf", stem_patches(x.double()),
                       w.reshape(25, 64).double())
    err = (got.double() - ref).abs().max().item()
    lim = TOL * ref.abs().max().item()
    assert (err <= lim) == agrees, (err / ref.abs().max().item(), TOL)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10   # TF32's unit at 1.0
    v = torch.tensor([one + ulp * 0.49, one + ulp * 0.5, one + ulp * 0.51,
                      -(one + ulp * 0.5), one + ulp * 1.5, 3.0e-3],
                     dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one + ulp, -(one + ulp),
                         one + 2 * ulp], dtype=torch.float32)
    got = tf32_rna(v)
    assert torch.equal(got[:5], want)
    # the result has at most 11 significant bits; hi + lo is v exactly
    assert (got.view(torch.int32) & 0x1fff == 0).all()
    hi, lo = split(v)
    assert torch.equal(hi + lo, v)


def test_bilinear_conv_bound_counts_the_tf32_passes():
    """fp32: three TF32 passes at 495 TFLOP/s (the CUDA cores' 67 TFLOP/s
    figure stays available); bf16: the bf16 tensor cores' 989 TFLOP/s.
    chip_smoke.py bounds each kernel with the package's model, and the
    kernel's own cost() counts the three passes."""
    from terrain_tpu_torch.ops.kernels import bilinear_conv
    from terrain_tpu_torch.utils import roofline as cs

    flops = 2.0 * 4 * 4 * 64 * 64 * 9 * 512 * 128   # (4,64²,512)->128
    ms, by = cs.bound_ms(flops, 1e6, True, tf32_passes=3)
    assert by == "operations"
    assert bilinear_conv.cost("bilinear_conv", 4, 64, 64, 512, 128,
                              "float32")[::2] == (flops, 3)
    assert ms == pytest.approx(3 * flops / 495e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.46857, rel=1e-4)
    assert cs.bound_ms(flops, 1e6, False)[0] == \
        pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    assert cs.bound_ms(flops, 1e6, True)[0] == \
        pytest.approx(flops / 67e12 * 1e3, rel=1e-12)
    # bytes bound it when they take longer
    ms, by = cs.bound_ms(1.0, 3.35e12, True, tf32_passes=3)
    assert by == "bytes" and ms == pytest.approx(1e3)


def test_bilinear_conv_variants_edit_the_kernel_source():
    """Each numerical variant that tools/bilinear_conv_variants.py builds on
    the card is one edit of the kernel's source, and each edit still finds
    its target, so the tool measures what its names say."""
    from terrain_tpu_torch.tools import bilinear_conv_variants as bv
    from terrain_tpu_torch.tools.variants import edited_source

    def edited(edits):
        return edited_source("bilinear_conv", edits)

    shipped = edited([])
    for name, edits in bv.VARIANTS.items():
        assert (edited(edits) == shipped) == (name == "shipped"), name
    two = edited(bv.VARIANTS["two_acc"])
    assert two.count("mma_tf32(acc2[i][j]") == 2
    assert two.count("mma_tf32(acc[i][j]") == 1
    for name in ("drop_lo_hi", "drop_hi_lo"):
        assert edited(bv.VARIANTS[name]).count("mma_tf32(acc[i][j]") == 2


def test_conv_stem_variants_edit_the_kernel_source():
    """Each part that tools/conv_stem_variants.py leaves out on the card is
    an edit of the shipped source that still finds its target."""
    from terrain_tpu_torch.tools import conv_stem_variants as sv
    from terrain_tpu_torch.tools.variants import edited_source

    shipped = edited_source("conv_stem", [])
    for name, edits in sv.VARIANTS.items():
        assert (edited_source("conv_stem", edits) == shipped) == (
            name == "shipped"), name


def test_thin_s2_variants_edit_the_kernel_sources():
    """Each variant that tools/thin_s2_variants.py builds on the card is an
    edit of the shipped conv_thin.cu or conv_s2.cu that still finds its
    targets."""
    from terrain_tpu_torch.tools import thin_s2_variants as tv
    from terrain_tpu_torch.tools.variants import edited_source

    built = 0
    for name in ("conv_thin", "conv_s2"):
        shipped = edited_source(name, [])
        for var, (which, edits) in tv.VARIANTS.items():
            if which in ("both", name):
                built += 1
                assert (edited_source(name, edits) == shipped) == (
                    var == "shipped"), var
    assert built == len(tv.VARIANTS) + 1  # "shipped" of both sources
    bulk = edited_source("conv_thin", tv.VARIANTS["dx_bulk_store"][1])
    assert bulk.count("bulk_store(") == 2 and bulk.count("bulk_wait_read<") == 2


def test_variants_ptxas_summary_reads_registers_spills_and_frames():
    """The by-parts tools' ptxas reader: registers, spills and stack frame
    of each kernel whose mangled name matches, named by the groups."""
    from terrain_tpu_torch.tools import thin_s2_variants as tv
    from terrain_tpu_torch.tools.variants import ptxas_summary

    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114thin_dx_kernelIfLi4EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114thin_dx_kernelIfLi4EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z9unrelatedv' for 'sm_90a'
ptxas info    : Function properties for _Z9unrelatedv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 8 registers
"""
    assert ptxas_summary(log, tv._PTXAS) == {
        "thin_dx_kernel fLi4": "96 registers, 4 bytes spilled, 8 bytes of "
                               "stack frame"}
