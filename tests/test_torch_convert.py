"""The port's Lightning ``.ckpt`` <-> checkpoint converter
(``sgmse_tpu_torch.convert``) for the NCSN++ family and DCUNet, against the
JAX package's ``sgmse_tpu.convert``, on the CPU at small widths.

The reference-layout weights come from a JAX initialisation through JAX's
``export_ncsnpp_state_dict``, whose key order ``tests/test_export.py`` holds
against the reference's own modules; nothing is downloaded. Exact checks: the
port's import against ``convert.params_from_jax`` of the same tree, its export
against JAX's export (key for key, in order, the EMA shadows included), and
the round trips. The imported model's forward is held to JAX's imported
model within 1e-4 of max|out| (float32 convolutions in another order).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from sgmse_tpu import convert as jax_convert
from sgmse_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu_torch import checkpoint, convert
from sgmse_tpu_torch.model import ScoreModel

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(nf=16, ch_mult=(1, 1, 2), num_res_blocks=1, init_scale=1.0, n_fft=126,
             hop_length=32, num_frames=64)
MODELS = {  # name: (backbone, sde, settings, F)
    "ncsnpp": ("ncsnpp", "ouve", dict(SMALL, attn_resolutions=(16,)), 64),
    "ncsnpp_v2": ("ncsnpp_v2", "sbve", dict(SMALL, attn_resolutions=(16,),
                                            loss_type="data_prediction"), 64),
    "ncsnpp_48k": ("ncsnpp_48k", "ouve", SMALL, 64),
    # F = 512: attention on the sixth level, where image_size 256 would put it on the fifth
    "ncsnpp_nfft1022": ("ncsnpp", "ouve", dict(SMALL, ch_mult=(1,) * 6, n_fft=1022,
                                               attn_resolutions=(16,)), 512),
}
TOL = 1e-4


def _ema(tree):
    """EMA stand-in: 0.5x every leaf but the Fourier projection, which no EMA
    shadows (a buffer in the reference, stop-gradient'd in JAX)."""
    ema = jax.tree.map(lambda a: 0.5 * a, tree)
    ema["fourier"]["W"] = tree["fourier"]["W"]
    return ema


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request, tmp_path_factory):
    """A JAX initialisation of the model, its port checkpoint directory, its
    JAX (Orbax) checkpoint, and its reference .ckpt made by the JAX exporter."""
    backbone, sde, settings, f = MODELS[request.param]
    jmodel = JaxScoreModel(backbone, sde, **settings)
    x0 = np.zeros((1, 1, f, 16), np.complex64)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.dnn.init)(
        jax.random.key(1), x0, x0, np.full((1,), 0.5, np.float32))["params"])
    ema = _ema(params)
    cfg = jmodel.config_dict()
    tmp = tmp_path_factory.mktemp(request.param)
    jax_save_checkpoint(tmp / "jax", {"step": np.asarray(1234, np.int32), "params": params,
                                      "ema_params": ema,
                                      "num_updates": np.asarray(1234, np.int32)}, cfg)
    model = ScoreModel.from_config(cfg)

    def port_sd(tree):  # in the module's order, as the port's training saves it
        sd = convert.state_dict_from_jax(tree)
        return {k: sd[k] for k in model.dnn.state_dict()}

    checkpoint.save_checkpoint(tmp / "port", {
        "step": 1234, "params": port_sd(params), "ema_params": port_sd(ema),
        "num_updates": 1234}, model.config_dict())
    reference = jax_convert.export_lightning_checkpoint(str(tmp / "jax"), str(tmp / "ref.ckpt"))
    return dict(name=request.param, backbone=backbone, cfg=cfg, f=f, params=params, ema=ema,
                tmp=tmp, reference=reference, ckpt=tmp / "ref.ckpt")


def _assert_ckpts_equal(got, want):
    assert list(got["state_dict"]) == list(want["state_dict"])  # order: torch_ema's pairing
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], torch.as_tensor(v)), k
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert got["global_step"] == want["global_step"]
    assert set(got["ema"]) == set(want["ema"])
    for key in ("decay", "num_updates", "collected_params"):
        assert got["ema"][key] == want["ema"][key], key
    assert len(got["ema"]["shadow_params"]) == len(want["ema"]["shadow_params"])
    for g, w in zip(got["ema"]["shadow_params"], want["ema"]["shadow_params"]):
        assert torch.equal(g, w)


def test_import_equals_params_from_jax(case):
    model = convert.convert_lightning_checkpoint(case["ckpt"], case["tmp"] / "imported")
    settings = {k: v for k, v in model.dnn.config.items()}
    state, cfg = checkpoint.load_checkpoint(case["tmp"] / "imported")
    for key, tree in (("params", case["params"]), ("ema_params", case["ema"])):
        want = convert.params_from_jax(tree, case["backbone"], **settings, freq_bins=case["f"])
        assert list(state[key]) == list(model.dnn.state_dict()) and set(want) == set(state[key])
        for name, value in want.items():
            assert torch.equal(state[key][name], value), (key, name)
    for name, value in model.dnn.state_dict().items():  # the model holds the EMA weights
        assert torch.equal(value, state["ema_params"][name]), name
    assert state["step"] == state["num_updates"] == 1234
    assert cfg == dict(case["cfg"], image_size=case["f"]) == model.config_dict()


def test_export_equals_jax_export(case):
    got = convert.export_lightning_checkpoint(case["tmp"] / "port", case["tmp"] / "port.ckpt")
    _assert_ckpts_equal(got, case["reference"])
    _assert_ckpts_equal(torch.load(case["tmp"] / "port.ckpt", weights_only=False),
                        case["reference"])
    assert got["hyper_parameters"]["image_size"] == case["f"]


def test_shadow_params_follow_the_reference_trainable_order(case):
    """The reference's trainable parameters are its state_dict in registration
    order without the Fourier W (``tests/test_export.py`` holds JAX's export
    order to the reference modules); each shadow is that parameter's EMA."""
    got = convert.export_lightning_checkpoint(case["tmp"] / "port", case["tmp"] / "order.ckpt")
    ref_keys = list(case["reference"]["state_dict"])
    trainable = [k for k in ref_keys if not jax_convert._is_fourier_w(k)]
    assert len(trainable) == len(ref_keys) - 1 and ref_keys[0] == "dnn.output_layer.weight"
    assert convert._trainable(got["state_dict"]) == trainable
    ema_sd = jax_convert.export_ncsnpp_state_dict(case["ema"], **got["hyper_parameters"])
    for k, shadow in zip(trainable, got["ema"]["shadow_params"]):
        np.testing.assert_array_equal(shadow.numpy(), ema_sd[k[len("dnn."):]])


def test_ckpt_round_trip_is_bit_exact(case):
    """.ckpt -> port directory -> .ckpt, and port directory -> .ckpt -> port
    directory, EMA included; the config keeps its image_size convention."""
    convert.convert_lightning_checkpoint(case["ckpt"], case["tmp"] / "rt")
    back = convert.export_lightning_checkpoint(case["tmp"] / "rt", case["tmp"] / "rt.ckpt")
    _assert_ckpts_equal(back, case["reference"])
    convert.convert_lightning_checkpoint(case["tmp"] / "rt.ckpt", case["tmp"] / "rt2")
    (s0, c0), (s1, c1) = (checkpoint.load_checkpoint(case["tmp"] / d) for d in ("port", "rt2"))
    for key in ("params", "ema_params"):
        assert list(s0[key]) == list(s1[key])
        for name in s0[key]:
            assert torch.equal(s0[key][name], s1[key][name]), (key, name)
    assert c1 == dict(c0, image_size=case["f"]) and c0["image_size"] == 256


def test_imported_forward_matches_jax_import(case):
    model = convert.convert_lightning_checkpoint(case["ckpt"]).eval()
    jmodel, variables = jax_convert.convert_lightning_checkpoint(str(case["ckpt"]))
    rng = np.random.default_rng(2)
    shape = (2, 1, case["f"], 32)
    x, y = ((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
            .astype(np.complex64) for _ in range(2))
    t = np.array([0.2, 0.8], np.float32)
    want = np.asarray(jmodel.forward(variables, x, y, t))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_reference_style_ckpt_imports(tmp_path):
    """A .ckpt as the reference's Lightning writes it: hyper_parameters with the
    data module's and the trainer's settings, the PESQ loss's state_dict
    entries, no EMA entry (the EMA weights are then the weights)."""
    backbone, sde, settings, f = MODELS["ncsnpp_v2"]
    jmodel = JaxScoreModel(backbone, sde, **settings, pesq_weight=5e-4)
    x0 = np.zeros((1, 1, f, 16), np.complex64)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.dnn.init)(
        jax.random.key(4), x0, x0, np.full((1,), 0.5, np.float32))["params"])
    cfg = dict(jmodel.config_dict(), image_size=f)
    sd = {f"dnn.{k}": torch.from_numpy(np.array(v))
          for k, v in jax_convert.export_ncsnpp_state_dict(params, **cfg).items()}
    sd["pesq_loss.to_spec.window"] = torch.ones(512)
    hparams = dict(cfg, base_dir="/data/VB-DMD", batch_size=16, num_workers=8,
                   data_module_cls="sgmse.data_module.SpecsDataModule", gpus=1,
                   no_wandb=True, max_epochs=-1)
    torch.save({"state_dict": sd, "hyper_parameters": hparams, "global_step": 7},
               tmp_path / "ref.ckpt")
    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.convert",
                          str(tmp_path / "ref.ckpt"), str(tmp_path / "imported")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    state, config = checkpoint.load_checkpoint(tmp_path / "imported")
    assert config == cfg and state["step"] == 7
    want = convert.params_from_jax(params, backbone, **{
        k: v for k, v in ScoreModel.from_config(cfg).dnn.config.items()}, freq_bins=f)
    for key in ("params", "ema_params"):
        for name, value in want.items():
            assert torch.equal(state[key][name], value), (key, name)
    model = checkpoint.load_score_model(tmp_path / "imported")
    assert model.pesq_weight == 5e-4 and model._pesq_loss is not None

    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.convert",
                          str(tmp_path / "imported"), str(tmp_path / "back.ckpt")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    back = torch.load(tmp_path / "back.ckpt", weights_only=False)
    assert list(back["state_dict"]) == [k for k in sd if k.startswith("dnn.")]
    assert len(back["ema"]["shadow_params"]) == len(sd) - 2  # no pesq_loss, no Fourier W


def test_other_families_are_refused(tmp_path):
    torch.save({"state_dict": {}, "hyper_parameters": {"backbone": "unet"}},
               tmp_path / "d.ckpt")
    with pytest.raises(NotImplementedError, match="NCSN.. family and DCUNet"):
        convert.convert_lightning_checkpoint(tmp_path / "d.ckpt")


DCUNET = dict(dcunet_architecture="DCUNet-10", n_fft=64, hop_length=16, num_frames=32,
              dcunet_temb_layers_local=2)


def test_dcunet_ckpt_round_trip(tmp_path):
    """The DCUNet half: a reference .ckpt made by JAX's exporter from a JAX
    initialisation (running statistics set to seeded values) imports through
    ``python -m sgmse_tpu_torch.convert`` to what ``convert.params_from_jax``
    makes of the same trees, the statistics in ``model_state``; it exports back
    equal to JAX's export, key for key and bit for bit (``num_batches_tracked``
    and the EMA shadows included), and the port directory survives the trip."""
    jmodel = JaxScoreModel("dcunet", "ouve", **DCUNET)
    x0 = np.zeros((1, 1, 33, 32), np.complex64)
    variables = jax.tree.map(np.asarray, jax.jit(jmodel.dnn.init)(
        jax.random.key(5), x0, x0, np.full((1,), 0.5, np.float32)))
    rng = np.random.default_rng(6)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])
    params = variables["params"]
    ema = jax.tree.map(lambda a: 0.5 * a, params)
    ema["embed_gfp"]["W"] = params["embed_gfp"]["W"]
    cfg = jmodel.config_dict()
    jax_save_checkpoint(tmp_path / "jax", {
        "step": np.asarray(99, np.int32), "params": params, "ema_params": ema,
        "num_updates": np.asarray(99, np.int32), "model_state": {"batch_stats": stats}}, cfg)
    reference = jax_convert.export_lightning_checkpoint(str(tmp_path / "jax"),
                                                        str(tmp_path / "ref.ckpt"))
    assert any(k.endswith("num_batches_tracked") for k in reference["state_dict"])

    res = subprocess.run([sys.executable, "-m", "sgmse_tpu_torch.convert",
                          str(tmp_path / "ref.ckpt"), str(tmp_path / "imported")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    state, config = checkpoint.load_checkpoint(tmp_path / "imported")
    model = ScoreModel.from_config(config)
    assert config == cfg and state["step"] == state["num_updates"] == 99
    for key, tree in (("params", params), ("ema_params", ema)):
        want = convert.params_from_jax(tree, "dcunet", stats, **model.dnn.config)
        assert set(state[key]) | set(state["model_state"]) == set(want)
        for name, value in {**state[key], **state["model_state"]}.items():
            assert torch.equal(value, want[name]), (key, name)
    loaded = checkpoint.load_score_model(tmp_path / "imported")
    for name, value in loaded.dnn.state_dict().items():
        assert torch.equal(value, {**state["ema_params"], **state["model_state"]}[name]), name

    back = convert.export_lightning_checkpoint(tmp_path / "imported", tmp_path / "back.ckpt")
    want_hp = dict(reference["hyper_parameters"])
    want_hp.pop("image_size")  # JAX's exporter adds it to every backbone; DCUNet has none
    assert back["hyper_parameters"] == want_hp
    _assert_ckpts_equal(dict(back, hyper_parameters=reference["hyper_parameters"]), reference)
    convert.convert_lightning_checkpoint(tmp_path / "back.ckpt", tmp_path / "again")
    again, config2 = checkpoint.load_checkpoint(tmp_path / "again")
    assert config2 == config
    for key in ("params", "ema_params", "model_state"):
        assert list(again[key]) == list(state[key])
        assert all(torch.equal(again[key][n], state[key][n]) for n in state[key]), key
