"""Numerical variants of csrc/bilinear_conv.cu, checked and timed on one card.

    python3 -m terrain_tpu_torch.tools.bilinear_conv_variants

Builds the kernel as it is and copies of it with one edit each:
  two_acc     u_hi*w_hi in one accumulator, the small terms in a second, the
              two added at the end (one block an SM: it needs the registers);
  drop_lo_hi  without u_lo*w_hi (in bf16: a single TF32 pass, u_hi*w);
  drop_hi_lo  without u_hi*w_lo (fp32 only: bf16 has no w_lo);
and runs each on the same inputs in fp32 and bf16 at the two flagship decoder
shapes at batch 4, against `bilinear_conv_plain` (fp32, TF32 off).  Prints
per variant, shape and dtype: the error as a share of max|ref| and whether it
is within chip_smoke.py's fp32 tolerance (1e-4 x max|ref|); in bf16 the
share of outputs whose bits differ from the plain version's (which rounds an
fp32 sum once), where a dropped product shows at bf16 precision; the time
(CUDA events, median of 30 launches after 3 warm-up); and ptxas's registers
and spills.  The edited copies live in a temporary directory; the kernels'
build directory is not touched.
"""

import ctypes
import json
import shutil
import statistics
import tempfile

from terrain_tpu_torch.tools.variants import bind, build_all, edited_source

F32_TOL = 1e-4
SHAPES = ((4, 64, 64, 512, 128), (4, 128, 128, 256, 64))
_PTXAS = r"bilinear_conv_kernelI(f|13__nv_bfloat16)"
_SMALL_FIRST = "for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al, bh[j]);"
_CROSS = "for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah, bl[j]);"
VARIANTS = {
    "shipped": [],
    "two_acc": [
        ("float acc[4][4][4];", "float acc[4][4][4], acc2[4][4][4];"),
        ("acc[i][j][k] = 0.f;", "acc[i][j][k] = acc2[i][j][k] = 0.f;"),
        (_SMALL_FIRST, _SMALL_FIRST.replace("acc[i][j]", "acc2[i][j]")),
        (_CROSS, _CROSS.replace("acc[i][j]", "acc2[i][j]")),
        ("acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1",
         "(acc[i][j][2 * h] + acc2[i][j][2 * h]) + b0, "
         "(acc[i][j][2 * h + 1] + acc2[i][j][2 * h + 1]) + b1"),
        ("__launch_bounds__(NTHREADS, 2)", "__launch_bounds__(NTHREADS, 1)"),
    ],
    "drop_lo_hi": [(_SMALL_FIRST, "for (int j = 0; j < 4; ++j) {}")],
    "drop_hi_lo": [(_CROSS, "for (int j = 0; j < 4; ++j) {}")],
}


def time_ms(torch, fn, reps=30, warm=3):
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def main():
    import torch

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.ops.kernels.bilinear_conv import (
        _DTYPES, bilinear_conv_plain)

    if not torch.cuda.is_available():
        raise SystemExit("bilinear_conv_variants: no CUDA device")
    strict_fp32()
    tmp = tempfile.mkdtemp(prefix="bilinear_conv_variants.")
    try:
        built = build_all(tmp, {
            name: edited_source("bilinear_conv", edits)
            for name, edits in VARIANTS.items()}, _PTXAS)
        fns = {}
        for name, (so, regs) in built.items():
            fns[name] = bind(so, "bilinear_conv_launch",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
            print(f"ptxas {name}: {regs}", flush=True)
        rows = []
        g = torch.Generator(device="cuda").manual_seed(1234)
        stream = torch.cuda.current_stream().cuda_stream
        for n, h, w, c, f in SHAPES:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((n, h, w, c), generator=g,
                                device="cuda").to(dt)
                wt = (torch.randn((3, 3, c, f), generator=g, device="cuda")
                      * (9 * c) ** -0.5).to(dt)
                b = torch.randn((f,), generator=g, device="cuda") * 0.1
                ref = bilinear_conv_plain(x, wt, b)
                top = ref.float().abs().max().item()
                y = torch.empty_like(ref)

                for name, fn in fns.items():
                    if name == "drop_hi_lo" and dt != torch.float32:
                        continue

                    def run(fn=fn):
                        rc = fn(x.data_ptr(), wt.data_ptr(), b.data_ptr(),
                                y.data_ptr(), n, h, w, c, f, _DTYPES[dt],
                                stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: launch failed {rc}")

                    y.fill_(float("nan"))
                    run()
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item() / top
                    row = dict(variant=name, shape=[n, h, w, c, f],
                               dtype=str(dt).split(".")[-1], err_share=err)
                    if dt == torch.float32:
                        row["within_f32_tol"] = err <= F32_TOL
                    else:
                        row["bits_differ_share"] = (
                            (y != ref).float().mean().item())
                    row["ms"] = time_ms(torch, run)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                del x, wt, b, ref, y
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


if __name__ == "__main__":
    main()
