"""The accurate weight gradient of fp32 5x5 stride-1 'same' convs with cin
>= 64 (ops/conv.py `Conv5x5`, `conv5x5_dw`), the DCGAN discriminator's
hidden layers, on the CPU: dW and dX against jax.grad of terrain_tpu's
conv at 1e-5 of the largest entry and against fp64, the same bits twice,
an output-feature slice of the weight (tensor parallelism), and the
dispatch rule: fp32, 5x5, stride 1, 'same', cin >= 64 and nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from terrain_tpu.ops import conv as jconv
from terrain_tpu_torch.ops import conv
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_TOL = 1e-5  # x the largest entry: fp32 sums in another order
F64_TOL = 2e-6  # x the largest entry: fp32 against exact


def _inputs(shape, cout, seed):
    r = np.random.RandomState(seed)
    n, h, w, cin = shape
    x = r.randn(n, h, w, cin).astype(np.float32)
    wt = (r.randn(5, 5, cin, cout) * (25 * cin) ** -0.5).astype(np.float32)
    g = r.randn(n, h, w, cout).astype(np.float32)
    return x, wt, g


def _port_grads(x, w_hwio, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(w_hwio, (3, 2, 0, 1)))).to(dtype).requires_grad_()
    y = conv.conv2d(xt, wt, stride=1, padding="same")
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g).to(dtype))
    return dx.double().numpy(), dw.double().permute(2, 3, 1, 0).numpy()


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 64), 8),
                                        ((3, 12, 10, 72), 16)])
def test_route_matches_jax_grad_and_fp64(shape, cout):
    x, w, g = _inputs(shape, cout, seed=shape[1])

    def f(xx, ww):
        return jnp.vdot(jconv.conv2d(xx, ww, stride=1, padding="same"), g)

    jdx, jdw = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    dx, dw = _port_grads(x, w, g)
    rdx, rdw = _port_grads(x, w, g, torch.float64)
    assert _rel(dw, np.asarray(jdw)) <= JAX_TOL
    assert _rel(dx, np.asarray(jdx)) <= JAX_TOL
    assert _rel(dw, rdw) <= F64_TOL and _rel(dx, rdx) <= F64_TOL


def test_dw_is_the_same_bits_twice_in_any_blocking():
    x, _, g = _inputs((2, 9, 7, 64), 3, seed=0)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    w0 = torch.zeros(3, 64, 5, 5, dtype=torch.float64)
    want = torch.ops.aten.convolution_backward(
        gt.double(), xt.double(), w0, None, (1, 1), (2, 2), (1, 1), False,
        (0, 0), 1, (False, True, False))[1]
    first = conv.conv5x5_dw(xt, gt)
    assert first.equal(conv.conv5x5_dw(xt, gt))
    assert first.is_contiguous() and first.shape == (3, 64, 5, 5)
    for block in (64, 100, 4096):
        got = conv.conv5x5_dw(xt, gt, block=block)
        assert _rel(got.double().numpy(), want.numpy()) <= F64_TOL


def test_a_weight_slice_gets_its_slice_of_dw():
    """Tensor parallelism hands the route an output-feature slice."""
    x, w, g = _inputs((2, 8, 8, 64), 8, seed=1)
    _, dw = _port_grads(x, w, g)
    _, dw_half = _port_grads(x, w[..., 4:], g[..., 4:])
    np.testing.assert_allclose(dw_half, dw[..., 4:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cin,k,stride,dtype,routed", [
    (64, 5, 1, torch.float32, True),
    (63, 5, 1, torch.float32, False),
    (64, 3, 1, torch.float32, False),
    (64, 5, 2, torch.float32, False),
    (64, 5, 1, torch.bfloat16, False),
])
def test_the_route_is_a_shape_and_dtype_rule(cin, k, stride, dtype, routed,
                                             monkeypatch):
    calls = []
    apply = conv.Conv5x5.apply
    monkeypatch.setattr(conv.Conv5x5, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    x = torch.randn(1, 8, 8, cin)
    w = torch.randn(4, cin, k, k)
    y = conv.conv2d(x, w, stride=stride, padding="same", compute_dtype=dtype)
    assert bool(calls) == routed
    ref = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), w.to(dtype),
                   stride=stride, padding=(k - 1) // 2).permute(0, 2, 3, 1)
    torch.testing.assert_close(y, ref)
