"""terrain_tpu_torch's sampler service on the CPU at the smoke_synthetic
size: ops, buckets, streaming, png payloads, errors, and wire compatibility
with terrain_tpu's client.  Served arrays are compared with the port's local
sampler on the same z at 1e-5 (same code, same device; only the batch
padding differs), png payloads within their documented quantization."""

import threading

import numpy as np
import pytest
import torch

from terrain_tpu.serve import TerrainClient as JaxClient
from terrain_tpu.serve.protocol import decode_array_png as jax_decode_png
from terrain_tpu.serve.protocol import encode_array_png as jax_encode_png
from terrain_tpu_torch import device
from terrain_tpu_torch.experiments import build_model
from terrain_tpu_torch.serve import (
    MicroBatcher, TerrainClient, TerrainServer, bucket_size)
from terrain_tpu_torch.serve import __main__ as cli
from terrain_tpu_torch.serve.png import decode_png, encode_png
from terrain_tpu_torch.serve.protocol import (
    decode_array, decode_array_png, decode_payload, encode_array,
    encode_array_png)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE, LATENT = 64, 32
Q16, Q8 = 0.5 / 65535 + 1e-7, 0.5 / 127.5 + 1e-7


@pytest.fixture(scope="module")
def server():
    pipe, _ = build_model("smoke_synthetic", "cpu", seed=3)
    srv = TerrainServer(pipe, port=0, max_batch=4, wait_ms=2.0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _z(seed, n):
    return np.random.RandomState(seed).rand(n, LATENT).astype(np.float32)


def test_protocol_roundtrips_and_png_codec():
    rng = np.random.RandomState(0)
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.array(3.5, np.float64)):
        out = decode_array(encode_array(arr))
        assert out.dtype == arr.dtype and out.shape == arr.shape
    h = rng.rand(3, 16, 16, 1).astype(np.float32)
    t = (rng.rand(2, 16, 16, 3) * 2 - 1).astype(np.float32)
    ph, pt = encode_array_png(h, "heightmap"), encode_array_png(t, "texture")
    assert np.abs(decode_array_png(ph) - h).max() <= Q16
    assert np.abs(decode_array_png(pt) - t).max() <= Q8
    # both packages decode each other's PNGs to the same arrays
    np.testing.assert_array_equal(jax_decode_png(ph), decode_array_png(ph))
    np.testing.assert_array_equal(
        decode_array_png(jax_encode_png(t, "texture")), decode_array_png(pt))
    np.testing.assert_array_equal(
        decode_array_png(jax_encode_png(h, "heightmap")), decode_array_png(ph))
    for img in (rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
                rng.randint(0, 65536, (6, 4)).astype(np.uint16)):
        back = decode_png(encode_png(img, level=9))
        np.testing.assert_array_equal(back.reshape(img.shape), img)
    with pytest.raises(ValueError, match="kind"):
        encode_array_png(h, "nope")
    with pytest.raises(ValueError, match="payload"):
        decode_payload(123)


def test_bucket_size_and_batcher_coalescing():
    assert [bucket_size(n, 8) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    seen = []
    mb = MicroBatcher(lambda op, rs: seen.append(len(rs)) or rs,
                      max_batch=4, wait_ms=200.0)
    futs = [mb.submit("op", i, 1) for i in range(3)]
    assert [f.result(timeout=10) for f in futs] == [0, 1, 2]
    assert seen == [3]
    mb.shutdown()


def test_gz_matches_local_sampler(server):
    pipe = server.model
    with TerrainClient(port=server.port) as c:
        assert (c.latent_dim, c.in_shp, c.max_batch) == (LATENT, SIZE, 4)
        h, t = c.generate(3, seed=11)
        h3, t3 = c.generate(1, seed=5, texture=False)
        hs, ts = c.generate(3, seed=11, deterministic=False)
    a, b = pipe.two_stage_det(torch.from_numpy(_z(11, 3)))
    np.testing.assert_allclose(h, a.numpy(), atol=1e-5)
    np.testing.assert_allclose(t, b.numpy(), atol=1e-5)
    assert t3 is None and h3.shape == (1, SIZE, SIZE, 1)
    assert hs.shape == h.shape and np.isfinite(ts).all()
    assert 0.0 <= hs.min() and hs.max() <= 1.0 and np.abs(ts).max() <= 1.0
    assert not np.array_equal(hs, h)  # batch statistics, not running ones


def test_atob_matches_local_sampler(server):
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 1).astype(np.float32)
    with TerrainClient(port=server.port) as c:
        remote = c.texture_for(x)
        single = c.texture_for(x[0])
        stoch = c.texture_for(x, deterministic=False)
    local = server.model.atob_det(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(remote, local, atol=1e-5)
    np.testing.assert_allclose(single, local[0], atol=1e-5)
    assert stoch.shape == local.shape and np.isfinite(stoch).all()


def test_interp_and_streaming(server):
    with TerrainClient(port=server.port) as c:
        h, t = c.interpolate(seed=9, steps=6)
        chunks = list(c.iter_interpolate(seed=9, steps=6))
        hp = np.concatenate([hc for _, hc, _ in
                             c.iter_interpolate(seed=9, steps=6, enc="png")])
        assert c.health()["ok"]  # the connection is reusable after a stream
    assert h.shape == (6, SIZE, SIZE, 1) and t.shape == (6, SIZE, SIZE, 3)
    assert [s for s, _, _ in chunks] == [0, 4]  # buckets of 4 + 2
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]), h)
    np.testing.assert_array_equal(np.concatenate([c[2] for c in chunks]), t)
    assert np.abs(hp - h).max() <= Q16
    # the endpoints are the two seeded prior samples
    a, _ = server.model.two_stage_det(torch.from_numpy(_z(9, 2)))
    np.testing.assert_allclose(h[[0, -1]], a.numpy(), atol=1e-5)


def test_png_is_the_quantized_npy(server):
    with TerrainClient(port=server.port) as c:
        h, t = c.generate(2, seed=21)
        hp, tp = c.generate(2, seed=21, enc="png")
        x = np.random.RandomState(1).rand(1, SIZE, SIZE, 1).astype(np.float32)
        ta, tb = c.texture_for(x), c.texture_for(x, enc="png")
    assert np.abs(hp - h).max() <= Q16 and np.abs(tp - t).max() <= Q8
    assert np.abs(tb - ta).max() <= Q8
    # device quantization == host quantization of the exact floats
    np.testing.assert_array_equal(
        hp, decode_array_png(encode_array_png(h, "heightmap")))
    np.testing.assert_array_equal(
        tp, decode_array_png(encode_array_png(t, "texture")))


def test_jax_client_talks_to_the_port(server):
    with JaxClient(port=server.port) as c:
        assert (c.latent_dim, c.in_shp) == (LATENT, SIZE)
        h, t = c.generate(2, seed=4)
        hp, tp = c.generate(2, seed=4, enc="png")
        tex = c.texture_for(h)
        frames = list(c.iter_interpolate(seed=1, steps=5, enc="png"))
    a, b = server.model.two_stage_det(torch.from_numpy(_z(4, 2)))
    np.testing.assert_allclose(h, a.numpy(), atol=1e-5)
    np.testing.assert_allclose(tex, b.numpy(), atol=1e-5)
    assert np.abs(hp - h).max() <= Q16 and np.abs(tp - t).max() <= Q8
    assert [f[0] for f in frames] == [0, 4]


def test_error_paths(server):
    with TerrainClient(port=server.port) as c:
        with pytest.raises(RuntimeError, match="unknown op"):
            c.request({"op": "nope"})
        with pytest.raises(RuntimeError, match="n must be"):
            c.request({"op": "gz", "n": 99})
        with pytest.raises(RuntimeError, match="heightmap must be"):
            c.request({"op": "atob", "heightmap": encode_array(
                np.zeros((2, 4, 4, 1), np.float32))})
        with pytest.raises(RuntimeError, match="enc must be"):
            c.request({"op": "gz", "n": 1, "enc": "jpeg"})
        with pytest.raises(RuntimeError, match="steps must be"):
            c.request({"op": "interp", "steps": 1})
        h, _ = c.generate(1, seed=1, texture=False)  # the server survives
    assert h.shape == (1, SIZE, SIZE, 1)


def test_concurrent_clients_coalesce(server):
    before = server.batcher.snapshot()
    results, barrier = {}, threading.Barrier(4)

    def one(i):
        with TerrainClient(port=server.port) as c:
            barrier.wait(timeout=30)
            results[i] = c.generate(1, seed=100 + i)[0]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    after = server.batcher.snapshot()
    assert after["requests"] - before["requests"] == 4
    for i in range(4):
        a, _ = server.model.two_stage_det(torch.from_numpy(_z(100 + i, 1)))
        np.testing.assert_allclose(results[i], a.numpy(), atol=1e-5)


def test_warmup_bypasses_the_batcher(server):
    before = server.batcher.snapshot()
    server.warmup()
    assert server.batcher.snapshot() == before


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("smoke_synthetic")
    assert device.resolve_device("cpu").type == "cpu"
    with pytest.raises(SystemExit):
        cli.main(["not_an_experiment", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["smoke_synthetic", "--no-weights", "--port", "0"])
