"""The trainer's architecture dumps in terrain_tpu_torch against
terrain_tpu's, on the CPU: `models/core.describe` gives terrain_tpu's text
for each network of its tiny trainer configuration and of smoke_synthetic
(the same weights: the port's carried into terrain_tpu's trees);
`utils/arch_diagram.draw_network` draws terrain_tpu's blocks (matplotlib
exists here); a fresh verbose `TwoStageGAN.train` writes arch_<net>.txt
and arch_<net>.png for the four networks, and without matplotlib the text
and one line saying the pictures were skipped.
"""

import os
import sys

import jax
import numpy as np
import pytest

from terrain_tpu.models import dcgan as jdcgan
from terrain_tpu.models import unet as junet
from terrain_tpu.models.core import describe as jdescribe
from terrain_tpu.utils import arch_diagram as jarch
from terrain_tpu_torch.data import Hdf5Iterator
from terrain_tpu_torch.data.synthetic import make_pairs
from terrain_tpu_torch.models import convert, dcgan, unet
from terrain_tpu_torch.models.core import describe
from terrain_tpu_torch.train.trainer import TwoStageGAN
from terrain_tpu_torch.utils import arch_diagram
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (factory args, kwargs) of each network: terrain_tpu's tests/test_trainer.py
# tiny_model and experiments' smoke_synthetic
CONFIGS = {
    "tiny": {
        "dcgan_gen": ((8, True), {"nch": 8, "h": 3, "initial_size": 4,
                                  "final_size": 16, "div": [2, 2]}),
        "dcgan_disc": ((16, True), {"nch": 16, "h": 3, "div": [4, 2],
                                    "bn": False, "nonlinearity": "linear"}),
        "p2p_gen": ((16, True, False), {"nf": 4, "act": "tanh"}),
        "p2p_disc": ((16, True, False), {"nf": 4, "bn": False,
                                         "act": "linear"}),
    },
    "smoke_synthetic": {
        "dcgan_gen": ((32, True), {"nch": 64, "h": 3, "initial_size": 4,
                                   "final_size": 64, "div": [2, 2, 4, 4]}),
        "dcgan_disc": ((64, True), {"nch": 64, "h": 3, "div": [4, 2, 2, 1],
                                    "bn": False, "nonlinearity": "linear"}),
        "p2p_gen": ((64, True, False), {"nf": 8, "act": "tanh",
                                        "bilinear_upsample": True}),
        "p2p_disc": ((64, True, False), {"nf": 8, "bn": False,
                                         "act": "linear"}),
    },
}
FACTORIES = {"dcgan_gen": (jdcgan.default_generator, dcgan.default_generator),
             "dcgan_disc": (jdcgan.default_discriminator,
                            dcgan.default_discriminator),
             "p2p_gen": (junet.g_unet, unet.g_unet),
             "p2p_disc": (junet.discriminator, unet.discriminator)}


def _pair(config, net):
    """(terrain_tpu network, its params and state, the port's network with
    those weights)."""
    args, kw = CONFIGS[config][net]
    jf, tf = FACTORIES[net]
    jnet = jf(*args, **kw)
    params, state = jnet.init(jax.random.PRNGKey(0))
    mine = tf(*args, **kw)
    convert.load_jax(mine, jax.tree.map(np.asarray, params),
                     jax.tree.map(np.asarray, state))
    return jnet, params, state, mine


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("net", sorted(FACTORIES))
def test_describe_gives_terrain_tpus_text(config, net):
    jnet, params, state, mine = _pair(config, net)
    # terrain_tpu's text for the port's own weights, carried across
    mine_params = jax.tree.map(np.asarray, convert.to_jax(mine)[0])
    assert describe(mine) == jdescribe(jnet, params, state)
    assert describe(mine) == jdescribe(jnet, mine_params, state)


@pytest.mark.parametrize("net", sorted(FACTORIES))
def test_draw_network_draws_terrain_tpus_blocks(tmp_path, net):
    pytest.importorskip("matplotlib")
    jnet, params, _, mine = _pair("smoke_synthetic", net)
    assert arch_diagram._blocks(convert.to_jax(mine)[0]) == \
        jarch._blocks(params)
    n = arch_diagram.draw_network(mine, str(tmp_path / "a.png"))
    assert n == len(jarch._blocks(params))
    with open(tmp_path / "a.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _train_fresh(out, capsys):
    nets = CONFIGS["tiny"]
    gan = TwoStageGAN(
        gen_fn_dcgan=dcgan.default_generator,
        disc_fn_dcgan=dcgan.default_discriminator,
        gen_params_dcgan=nets["dcgan_gen"][1],
        disc_params_dcgan=nets["dcgan_disc"][1],
        gen_fn_p2p=unet.g_unet, disc_fn_p2p=unet.discriminator,
        gen_params_p2p=nets["p2p_gen"][1],
        disc_params_p2p=nets["p2p_disc"][1], in_shp=16, latent_dim=8,
        is_a_grayscale=True, is_b_grayscale=False, lsgan=True,
        opt="rmsprop", opt_args={"learning_rate": 1e-4}, verbose=True,
        device="cpu")
    x, y = make_pairs(8, 16, seed=0)
    xv, yv = make_pairs(4, 16, seed=1)
    np.random.seed(0)
    capsys.readouterr()
    gan.train(Hdf5Iterator(x, y, 4), Hdf5Iterator(xv, yv, 4), 4, 1,
              str(out), None, quick_run=True)
    return gan, capsys.readouterr().out


def test_a_fresh_run_writes_the_eight_files(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    gan, printed = _train_fresh(tmp_path, capsys)
    for name, net in gan.nets.items():
        assert (tmp_path / f"arch_{name}.txt").read_text() == describe(net)
        with open(tmp_path / f"arch_{name}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert "skipped" not in printed


def test_without_matplotlib_the_pictures_are_skipped_in_one_line(
        tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    gan, printed = _train_fresh(tmp_path, capsys)
    for name in gan.nets:
        assert (tmp_path / f"arch_{name}.txt").exists()
        assert not (tmp_path / f"arch_{name}.png").exists()
    lines = [ln for ln in printed.splitlines() if "skipped" in ln]
    assert len(lines) == 1 and "matplotlib" in lines[0]
    assert not os.path.exists(tmp_path / "arch_dcgan_gen.png")
