"""The DCGAN discriminator's 5x5 stride-1 'same' convolutions with cin >=
64 in fp32, on the card: which library kernels compute their gradients,
how far each gradient is from fp64, and what it costs.

For every such conv of the flagship's discriminator (test1_nobn_bilin_both:
512px, batch 4, so its discriminator-path call holds 8 rows), under the
port's numerics (`device.strict_fp32`: TF32 off, cuDNN's deterministic
algorithms) and under cuDNN's default algorithms:
  * the kernels that compute dW alone and dX alone, by name and device
    time (torch.profiler);
  * dW and dX against cuDNN's fp64 gradients (the `determinism` phase of
    chip_smoke.py measured cuDNN's fp64 within 1e-14 of the CPU's), as the
    largest error over the largest entry, on seeded normal inputs;
  * CUDA-event times (median of 10 after warm-up) of each gradient, and
    of two routes to an accurate dW: (a) the port's
    `ops/conv.conv5x5_dw`, tap-shifted fp32 products over blocks of rows
    (one product a kernel row), and (b) cuDNN's fp64 dW on casts of x
    and g, with their errors and whether (a) gives the same bits twice.

    python3 -m terrain_tpu_torch.tools.conv5_dw     # on the card, ~30 s
"""

import statistics
import subprocess
import sys

import torch

from terrain_tpu_torch.device import strict_fp32
from terrain_tpu_torch.experiments import _test1

BATCH = 8  # the discriminator path's call: real and fake rows of batch 4
REPS = 10


def shapes():
    """[(x NHWC shape, cout)] of the 5x5 convs with cin >= 64."""
    cfg = _test1(True)["dcgan_disc"]
    size, nch, out = 512, 512, []
    cin = 1
    for d in cfg["div"]:
        if cin >= 64:
            out.append(((BATCH, size, size, cin), nch // d))
        cin, size = nch // d, size // 2
    out.append(((BATCH, size, size, cin), 1))  # conv_out
    return out


def _grad(g, x, w, mask):
    return torch.ops.aten.convolution_backward(
        g, x, w, None, (1, 1), (2, 2), (1, 1), False, (0, 0), 1, mask)


def _ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key[:90]: round(ev.self_device_time_total / 1e3, 4)
            for ev in prof.key_averages()
            # a CudaKernel.launch label's device span repeats its kernel's
            if ev.self_device_time_total > 0 and not ev.is_user_annotation}


def _err(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max())


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 2
    strict_fp32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for xs, cout in shapes():
        n, h, wd, cin = xs
        # NHWC storage viewed as NCHW, as ops/conv.py hands it to cuDNN
        x = torch.randn(xs, device="cuda", generator=gen).permute(0, 3, 1, 2)
        w = torch.randn((cout, cin, 5, 5), device="cuda", generator=gen)
        w = w * (cin * 25) ** -0.5
        g = torch.randn((n, h, wd, cout), device="cuda",
                        generator=gen).permute(0, 3, 1, 2)
        ref = _grad(g.double(), x.double(), w.double(), (True, True, False))
        print(f"conv5x5 x{tuple(x.shape)} w{tuple(w.shape)}", flush=True)
        for label, det in (("deterministic", True), ("default", False)):
            for name, k, mask in (("dX", 0, (True, False, False)),
                                  ("dW", 1, (False, True, False))):
                def run():
                    return _grad(g, x, w, mask)[k]

                with torch.backends.cudnn.flags(
                        enabled=True, benchmark=False, deterministic=det,
                        allow_tf32=False):
                    print(f"  cuDNN {label}: {name} err "
                          f"{_err(run(), ref[k]):.2e} {_ms(run):.4f} ms "
                          f"{_kernels(run)}", flush=True)
        _routes(x, g, w, ref[1])
        del x, w, g, ref
        torch.cuda.empty_cache()
    return 0


def _routes(x, g, w, ref_dw):
    """(a) the port's route, (b) cuDNN's fp64 dW on casts of x and g."""
    from terrain_tpu_torch.ops.conv import conv5x5_dw

    def route():
        return conv5x5_dw(x, g)

    def fp64():
        return _grad(g.double(), x.double(), w.double(),
                     (False, True, False))[1].float()

    dw = route()
    print(f"  route (a) dW err {_err(dw, ref_dw):.2e}, the same bits twice "
          f"{bool(dw.equal(route()))}, {_ms(route):.4f} ms "
          f"{_kernels(route)}", flush=True)
    print(f"  route (b) cuDNN fp64 dW on casts: err "
          f"{_err(fp64(), ref_dw):.2e} {_ms(fp64):.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
