"""conv_thin's dX and conv_s2's dW+db kernels measured by parts on one card.

    python3 -m terrain_tpu_torch.tools.thin_s2_variants

Builds conv_thin.cu and conv_s2.cu as they are and copies of them with one
or more edits each, and calls their C entry points through ctypes.
Variants: dX without its products, without writing dX, without its g rows,
with the strip row's output staged in shared memory and written by one
bulk store (bulk_store), held to 80 registers for three blocks an SM
(3_blocks); dW without its products, with every tile completing its stage
with no bytes (no_copies), without its x rows (no_x), with 512 threads a
block (512_threads), with its pixel loop unrolled by two (unroll2);
at the main path's shapes in fp32 and bf16: dX (4,256,256) x 4 -> 64, dW+db
(8,512,512,4) x 64 with the leaky mask and (4,512,512,1) x 64 without.
Prints per variant, shape and dtype `single` (one launch between two CUDA
events after a synchronize, host cost included) and `stream` (20 launches
back to back per event pair, divided by 20), medians of 10; each variant's
error against the plain version (a variant that leaves out a part is not
expected to agree); and ptxas's registers, spills and stack frames.  The
edited copies live in a temporary directory; the kernels' build directory
is not touched.
"""

import shutil
import subprocess
import tempfile

from terrain_tpu_torch.tools.variants import (bind, build_all, edited_source,
                                              times_ms)

DX_SHAPES = ((4, 256, 256, 64, 4),)
DW_SHAPES = ((8, 512, 512, 4, 64, 0.01), (4, 512, 512, 1, 64, None))
_PTXAS = r"((?:thin|s2)_d[xw]_kernel)I(\w*?)E+v"

_DX_MATH = ("for (int dy = 0; dy < 3; ++dy) {  // dX taps",
            "for (int dy = 0; dy < 0; ++dy) {  // dX taps")
_DX_STORE = ("    if (row && active) {  // dX row out",
             "    if (row && active && acc[0][0] == 1.25e-38f) {")
# dX's output row staged in shared memory (two buffers a row group) and
# written by one bulk store of the row group's first thread
_BULK_HELPERS = r"""
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
"""
_BULK_STORE = """    {
      T* so = reinterpret_cast<T*>(sg + S * SWP * FP) +
              (((k / R) & 1) * R + gr_) * SW * C;
      if (row && active)
        for (int p = 0; p < P; ++p)
          store4(so + (run * P + p) * C + 4 * q, acc[p]);
      fence_proxy_async();
      __syncthreads();
      if (tid % GT == 0 && row) {
        bulk_store(dx + (((size_t)c.n * H + r) * W + col0) * C, so,
                   min(SW, W - col0) * C * sizeof(T));
        bulk_commit();
      }
    }
    if (false) {  // dX row out"""
_DX_BULK = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + _BULK_HELPERS),
    ("dx_stages<F>() * SWP * dx_fp<F>());",
     "dx_stages<F>() * SWP * dx_fp<F>()) + sizeof(T) * 2 * fwd_rows<F>() * "
     "SW * c;"),
    ("    store_g(k);\n    __syncthreads();",
     "    store_g(k);\n    if (tid % GT == 0) bulk_wait_read<1>();\n"
     "    __syncthreads();"),
    ("    if (row && active) {  // dX row out", _BULK_STORE),
    ("  }\n}\n\ntemplate <typename T, int F>\ncudaError_t dx_t(",
     "  }\n  if (tid % GT == 0) bulk_wait_read<0>();\n}\n\n"
     "template <typename T, int F>\ncudaError_t dx_t(")]
_DX_GROWS = ("const bool grow = ", "const bool grow = false && ")
_DW_MATH = ("for (int dy = 0; dy < K; ++dy)  // dW taps",
            "for (int dy = 0; dy < 0; ++dy)  // dW taps")
_DW_COPIES = ("const uint32_t bytes = np * F * sizeof(T);  // dW tile",
              "const uint32_t bytes = 0;  // dW tile")
_DW_X = ("const bool xrow = ", "const bool xrow = false && ")
VARIANTS = {
    "shipped": ("both", []),
    "dx_no_math": ("conv_thin", [_DX_MATH]),
    "dx_no_store": ("conv_thin", [_DX_STORE]),
    "dx_no_grows": ("conv_thin", [_DX_GROWS]),
    "dx_bulk_store": ("conv_thin", _DX_BULK),
    "dx_3_blocks": ("conv_thin", [
        ("__launch_bounds__(fwd_threads<F>())\n    thin_dx_kernel",
         "__launch_bounds__(fwd_threads<F>(), 3)\n    thin_dx_kernel")]),
    "dw_no_math": ("conv_s2", [_DW_MATH]),
    "dw_no_copies": ("conv_s2", [_DW_COPIES]),
    "dw_no_x": ("conv_s2", [_DW_X]),
    "dw_512_threads": ("conv_s2", [
        ("constexpr int DW_NT = 256;", "constexpr int DW_NT = 512;")]),
    "dw_unroll2": ("conv_s2", [
        ("    for (int p = 0; p < np; ++p) {",
         "#pragma unroll 2\n    for (int p = 0; p < np; ++p) {")]),
}


def main():
    import torch

    from terrain_tpu_torch.device import strict_fp32
    from terrain_tpu_torch.ops.kernels import conv_s2 as c2
    from terrain_tpu_torch.ops.kernels import conv_thin as ct

    if not torch.cuda.is_available():
        raise SystemExit("thin_s2_variants: no CUDA device")
    strict_fp32()
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="thin_s2_variants.")
    try:
        built = build_all(tmp, {
            (var, name): edited_source(name, edits)
            for var, (which, edits) in VARIANTS.items()
            for name in ("conv_thin", "conv_s2") if which in ("both", name)},
            _PTXAS)
        dx, dw = {}, {}
        for (var, name), (so, regs) in built.items():
            print(f"ptxas {var} {name}: {regs}", flush=True)
            if name == "conv_thin":
                dx[var] = bind(so, "conv_thin_dx_launch",
                               ct.KERNEL_DX.argtypes)
            else:
                dw[var] = bind(so, "conv_s2_dw_launch", c2.KERNEL_DW.argtypes)
        g = torch.Generator(device="cuda").manual_seed(1234)
        stream = torch.cuda.current_stream().cuda_stream
        nb = c2.DW_PER_SM * torch.cuda.get_device_properties(
            0).multi_processor_count

        def rand(shape, dt, scale=1.0):
            return (torch.randn(shape, generator=g, device="cuda")
                    * scale).to(dt)

        def report(kind, var, shape, dt, run, out, ref):
            one, many = times_ms(torch, run)
            e = max((o.float() - r.float()).abs().max().item()
                    / r.float().abs().max().item() for o, r in zip(out, ref))
            print(f"{kind} {var} {shape} {str(dt)[6:]}: single {one:.4f} "
                  f"ms, stream {many:.4f} ms, error {e:.2e} x max|ref|",
                  flush=True)

        for dt in (torch.float32, torch.bfloat16):
            code = ct._DTYPES[dt]
            for n, h, w, c, f in DX_SHAPES:
                gg = rand((n, h, w, f), dt)
                wt = rand((3, 3, c, f), dt, (9 * c) ** -0.5)
                ref = ct.conv_thin_dx_plain(gg, wt)
                out = torch.empty_like(ref)
                for var, fn in dx.items():
                    def run(fn=fn):
                        rc = fn(gg.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                n, h, w, c, f, code, stream)
                        if rc:
                            raise RuntimeError(f"{var}: launch failed {rc}")

                    report("dx", var, (n, h, w, c, f), dt, run, [out], [ref])
                del gg, wt, ref, out
            for n, h, w, c, f, slope in DW_SHAPES:
                x = rand((n, h, w, c), dt)
                gg = rand((n, h // 2, w // 2, f), dt)
                yy = rand((n, h // 2, w // 2, f), dt)
                dwr, dbr = c2.conv_s2_dw_plain(x, gg, yy, slope)
                rows = 9 * c + 1
                part = torch.empty((nb, rows * f), device="cuda")
                out = torch.empty((rows, f), device="cuda")
                for var, fn in dw.items():
                    def run(fn=fn):
                        rc = fn(x.data_ptr(), gg.data_ptr(), yy.data_ptr(),
                                part.data_ptr(), out.data_ptr(), nb, n, h, w,
                                c, f, int(slope is not None),
                                float(slope or 0.0), code, stream)
                        if rc:
                            raise RuntimeError(f"{var}: launch failed {rc}")

                    report("dw", var, (n, h, w, c, f, slope), dt, run,
                           [out[:rows - 1], out[rows - 1]],
                           [dwr.reshape(rows - 1, f), dbr])
                del x, gg, yy, part, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
