"""The stem's forward and dX kernels (csrc/conv_stem.cu) measured by parts
on one card.

    python3 -m terrain_tpu_torch.tools.conv_stem_variants

Builds the source as it is and copies of it with one edit each, and calls
their C entry points through ctypes:
  fwd_no_math    the forward without its products (and their x and w
                 loads): tiles of whatever shared memory holds, written out;
  fwd_no_store   the forward without writing y (the tiles are built);
  fwd_one_block  the forward with one block an SM, not as many as fit;
  dx_no_taps     dX without the tap values' products (and their loads);
  dx_no_convert  dX without the masked-g pass into the padded plane;
  dx_no_gather   dX without the sum of the 25 taps per output;
  dx_no_loads    dX with every row completing its stage with no bytes;
  dx_skeleton    dX without taps, conversion and sums: the copies alone;
  dx_skeleton_no_loads   and without the copies: the loop alone;
at the main path's shapes in fp32 and bf16: the forward (8,512,512,1) ->
64 and (4,512,512,1) -> 64 with the leaky epilogue, dX (4,512,512) x 64
with the mask.  Prints per variant, shape and dtype two times (CUDA
events, median of 10): `single`, one launch between two events after a
synchronize (as chip_smoke.py times a kernel, with the host's launch
overhead in it), and `stream`, 20 launches back to back per event pair,
divided by 20; the error of the shipped build against the plain version;
and ptxas's registers and spills.  The edited copies live in a temporary
directory; the kernels' build directory is not touched.
"""

import shutil
import tempfile

from terrain_tpu_torch.tools.variants import (bind, build_all, edited_source,
                                              times_ms)

FWD_SHAPES = ((8, 512, 512, 64), (4, 512, 512, 64))
DX_SHAPES = ((4, 512, 512, 64),)
SLOPE = 0.2
_PTXAS = r"stem_(fwd|dx)_kernelI(f|13__nv_bfloat16)Lb(\d)(?:ELb(\d))?"
_TAPS = ("if (lane < swp) {\n#pragma unroll 2", "if (false) {\n#pragma unroll 2")
_CONVERT = ("for (; p < swp;) {", "for (; p < 0;) {")
_GATHER = ("if (c.j < 4 || ct >= sw) return;", "return;")
_LOADS = ("if (gh < 0 || gh >= H) {\n      mbar_expect_tx(bar, 0);",
          "if (true) {\n      mbar_expect_tx(bar, 0);")
VARIANTS = {
    "shipped": [],
    "fwd_no_math": [("if (ng < NG) {", "if (false) {")],
    "fwd_no_store": [("i < np * FQ; i += NT) {", "i < 0; i += NT) {")],
    "fwd_one_block": [("(per_sm > 1 ? per_sm : 1)", "1")],
    "dx_no_taps": [_TAPS],
    "dx_no_convert": [_CONVERT],
    "dx_no_gather": [_GATHER],
    "dx_no_loads": [_LOADS],
    "dx_skeleton": [_TAPS, _CONVERT, _GATHER],
    "dx_skeleton_no_loads": [_TAPS, _CONVERT, _GATHER, _LOADS],
}


def main():
    import torch

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.ops.kernels import conv_stem as cs

    if not torch.cuda.is_available():
        raise SystemExit("conv_stem_variants: no CUDA device")
    strict_fp32()
    tmp = tempfile.mkdtemp(prefix="conv_stem_variants.")
    try:
        built = build_all(tmp, {name: edited_source("conv_stem", edits)
                                for name, edits in VARIANTS.items()}, _PTXAS)
        fwd, dx = {}, {}
        for name, (so, regs) in built.items():
            fwd[name] = bind(so, "conv_stem_fwd_launch",
                             cs.KERNEL_FWD.argtypes)
            dx[name] = bind(so, "conv_stem_dx_launch", cs.KERNEL_DX.argtypes)
            print(f"ptxas {name}: {regs}", flush=True)
        g = torch.Generator(device="cuda").manual_seed(1234)
        stream = torch.cuda.current_stream().cuda_stream
        for dt in (torch.float32, torch.bfloat16):
            code = cs._DTYPES[dt]
            for n, h, w, f in FWD_SHAPES:
                x = torch.randn((n, h, w, 1), generator=g,
                                device="cuda").to(dt)
                wt = (torch.randn((5, 5, 1, f), generator=g, device="cuda")
                      * 0.2).to(dt)
                b = torch.randn((f,), generator=g, device="cuda") * 0.1
                ref = cs.conv_stem_fwd_plain(x, wt, b, SLOPE)
                y = torch.empty_like(ref)
                for name, fn in fwd.items():
                    if name != "shipped" and not name.startswith("fwd"):
                        continue

                    def run(fn=fn):
                        rc = fn(x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                                y.data_ptr(), n, h, w, f, 1, SLOPE, code,
                                stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed {rc}")

                    one, many = times_ms(torch, run)
                    err = ""
                    if name == "shipped":
                        e = (y.float() - ref.float()).abs().max().item()
                        err = (f" error {e / ref.float().abs().max().item():.2e}"
                               f" x max|ref|")
                    print(f"fwd {name} {(n, h, w, f)} {str(dt)[6:]}: single "
                          f"{one:.4f} ms, stream {many:.4f} ms{err}",
                          flush=True)
                del x, ref, y
            for n, h, w, f in DX_SHAPES:
                gg = torch.randn((n, h, w, f), generator=g,
                                 device="cuda").to(dt)
                yy = torch.randn((n, h, w, f), generator=g,
                                 device="cuda").to(dt)
                wt = (torch.randn((5, 5, 1, f), generator=g, device="cuda")
                      * 0.2).to(dt)
                ref = cs.conv_stem_dx_plain(gg, wt, yy, SLOPE)
                out = torch.empty_like(ref)
                for name, fn in dx.items():
                    if name != "shipped" and not name.startswith("dx"):
                        continue

                    def run(fn=fn):
                        rc = fn(gg.data_ptr(), yy.data_ptr(), wt.data_ptr(),
                                out.data_ptr(), n, h, w, f, 1, SLOPE, code,
                                stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed {rc}")

                    one, many = times_ms(torch, run)
                    err = ""
                    if name == "shipped":
                        e = (out.float() - ref.float()).abs().max().item()
                        err = (f" error {e / ref.float().abs().max().item():.2e}"
                               f" x max|ref|")
                    print(f"dx {name} {(n, h, w, f)} {str(dt)[6:]}: single "
                          f"{one:.4f} ms, stream {many:.4f} ms{err}",
                          flush=True)
                del gg, yy, ref, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
