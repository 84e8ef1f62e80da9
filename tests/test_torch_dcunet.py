"""The port's DCUNet against the JAX package's, at small sizes: DilDCUNet-v2 at
n_fft 512 (F = 257, the smallest height its dilated encoders take) and
DCUNet-10 at n_fft 64 (F = 33), with T = 30 frames, which ``fix_length`` pads
or trims to the time-stride product.

Weights: the port's seeded init (every leaf, the CbN ``Wri`` and the biases
included, non-trivial), carried to JAX by ``convert.jax_variables_from_state_dict``,
whose tree must have the JAX initialisation's leaves and shapes. Inputs:
numpy, seeded. Tolerances: the float32 forward within 1e-4 of max|out| in
train and eval modes; the running statistics after one train-mode forward
within 1e-5 of each norm's statistics scale (max over its mean and var: a
channel's mean can be ~0, where a relative check would only measure the
forwards' rounding); bfloat16 against float32 within 0.1 of max|out| (as the
JAX package's own precision test holds it).
"""
import argparse

import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu.models.dcunet import DCUNet as JaxDCUNet
from sgmse_tpu_torch import convert, train
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.models.dcunet import DCUNet

T = 30
CASES = {
    "v2 bN gfp pad": (257, dict(dcunet_architecture="DilDCUNet-v2")),
    "v2 CbN complex gfp trim": (257, dict(dcunet_architecture="DilDCUNet-v2",
                                          dcunet_norm_type="CbN",
                                          dcunet_time_embedding_complex=True,
                                          dcunet_fix_length="trim")),
    "10 bN ds pad": (33, dict(dcunet_architecture="DCUNet-10", dcunet_time_embedding="ds",
                              dcunet_activation="leaky_relu", dcunet_temb_layers_local=2)),
    "10 CbN complex ds trim": (33, dict(dcunet_architecture="DCUNet-10", dcunet_norm_type="CbN",
                                        dcunet_time_embedding="ds",
                                        dcunet_time_embedding_complex=True,
                                        dcunet_fix_length="trim", dcunet_activation="silu")),
}
TOL, STATS_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(_shapes(value, path) if isinstance(value, dict) else {path: value.shape})
    return out


def _inputs(f, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x, y = ((rng.standard_normal((b, 1, f, T)) + 1j * rng.standard_normal((b, 1, f, T)))
            .astype(np.complex64) for _ in range(2))
    return x, y, rng.uniform(0.03, 1.0, b).astype(np.float32)


def _models(case, **extra):
    f, cfg = CASES[case]
    kw = dict(n_fft=2 * (f - 1), hop_length=16, num_frames=T, **cfg, **extra)
    port = ScoreModel("dcunet", "ouve", **kw)
    port.init_params(torch.Generator().manual_seed(2))
    jmodel = JaxScoreModel("dcunet", "ouve", **kw)
    variables = convert.jax_variables_from_state_dict(port.dnn.state_dict())
    x0 = np.zeros((1, 1, f, T), np.complex64)
    init = jax.eval_shape(lambda: jmodel.dnn.init(jax.random.key(0), x0, x0,
                                                  np.full((1,), 0.5, np.float32)))
    assert _shapes(variables) == _shapes(init)
    return port, jmodel, variables


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_statistics_match_jax(case, train_mode):
    port, jmodel, variables = _models(case)
    assert port.config_dict() == jmodel.config_dict()
    x, y, t = _inputs(CASES[case][0])
    out = jax.jit(lambda v, *a: jmodel.dnn.apply(
        v, *a, train=train_mode, mutable=["batch_stats"] if train_mode else False))(
        variables, x, y, t)
    ref, updates = (out if train_mode else (out, {}))
    port.dnn.train(train_mode)
    with torch.no_grad():
        got = port.dnn(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t)).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (3, 1, CASES[case][0], T) and got.dtype == np.complex64
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= TOL, err

    stats = convert.jax_tree_from_state_dict(port.dnn.state_dict(), "batch_stats")
    if "CbN" in case:  # batch statistics in both modes: no state
        assert not stats and not updates.get("batch_stats")
        return
    want = updates["batch_stats"] if train_mode else variables["batch_stats"]
    got_flat = convert.flatten_tree(stats)
    want_flat = convert.flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got_flat) == set(want_flat)
    for key in want_flat:
        norm = key.rsplit("/", 1)[0]
        scale = max(np.abs(want_flat[f"{norm}/{s}"]).max() for s in ("mean", "var"))
        assert np.abs(got_flat[key] - want_flat[key]).max() <= STATS_TOL * scale, key


def test_running_statistics_are_biased_and_follow_flax_momentum():
    """One train-mode forward from mean 0, var 1: mean = 0.1 m_batch and
    var = 0.9 + 0.1 v_batch with the biased (1/n) batch variance: the trap of
    torch's BatchNorm2d, which stores n / (n - 1) of it."""
    port, _, _ = _models("10 bN ds pad")
    x, y, t = _inputs(33, b=2)
    seen = {}
    bn = port.dnn.encoder0.norm
    bn.register_forward_hook(lambda m, args, out: seen.setdefault("x", args[0].detach()))
    port.dnn.train()
    with torch.no_grad():
        port.dnn(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t))
    re = seen["x"][:2]  # the stacked input's real half
    mean, var = re.mean(dim=(0, 2, 3)), re.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.re.mean, 0.1 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.re.var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("norm_type", ["bN", "CbN"])
def test_bf16_matches_f32_within_tolerance(norm_type):
    kw = dict(dcunet_norm_type=norm_type, n_fft=512, hop_length=128, num_frames=33)
    m32 = ScoreModel("dcunet", "ouve", precision="float32", **kw)
    m32.init_params(torch.Generator().manual_seed(0))
    m16 = ScoreModel("dcunet", "ouve", precision="bfloat16", **kw)
    m16.dnn.load_state_dict(m32.dnn.state_dict())
    assert {p.dtype for p in m16.dnn.state_dict().values()} == {torch.float32}
    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy((0.1 * (rng.standard_normal((2, 1, 257, 33)) + 1j
                                     * rng.standard_normal((2, 1, 257, 33))))
                             .astype(np.complex64)) for _ in range(2))
    t = torch.tensor([0.3, 0.7])
    with torch.no_grad():
        out32, out16 = (m.eval()(x, y, t) for m in (m32, m16))
    assert out16.dtype == torch.complex64 and torch.isfinite(torch.view_as_real(out16)).all()
    rel = ((out16 - out32).abs().max() / out32.abs().max()).item()
    assert rel < 0.1, rel


def _dnn_flags(parser_add):
    parser = argparse.ArgumentParser()
    parser_add(parser)
    return vars(parser.parse_args([]))


def test_config_dict_through_constructor_and_cli_parser():
    """The class defaults (two global layers, relu) and the CLI's (one,
    leaky_relu) differ, in both packages alike."""
    assert ScoreModel("dcunet", "ouve").config_dict() == \
        JaxScoreModel("dcunet", "ouve").config_dict()
    flags = _dnn_flags(DCUNet.add_argparse_args)
    assert flags == _dnn_flags(JaxDCUNet.add_argparse_args)
    assert (flags["dcunet_temb_layers_global"], flags["dcunet_activation"]) == (1, "leaky_relu")
    parser, args = train.build_parser(["--backbone", "dcunet", "--base_dir", "d", "--n_fft",
                                       "512", "--hop_length", "128"])
    groups = train._argument_groups(parser, args)
    port = ScoreModel("dcunet", "ouve", **{**groups["ScoreModel"], **groups["SDE"],
                                           **groups["Backbone"], **groups["DataModule"]})
    jax_cfg = JaxScoreModel("dcunet", "ouve", **{**groups["ScoreModel"], **groups["SDE"],
                                                  **flags, **groups["DataModule"]}).config_dict()
    assert port.config_dict() == jax_cfg
    assert jax_cfg["dcunet_temb_layers_global"] == 1 and jax_cfg["n_fft"] == 512


def test_mask_bound_and_bad_shapes_raise():
    with pytest.raises(NotImplementedError):
        ScoreModel("dcunet", "ouve", dcunet_mask_bound="tanh")
    port = ScoreModel("dcunet", "ouve", dcunet_fix_length="none", n_fft=64,
                      dcunet_architecture="DCUNet-10")
    x = torch.zeros(1, 1, 33, T, dtype=torch.complex64)
    with pytest.raises(TypeError, match="time divisible"):
        port.dnn(x, x, torch.tensor([0.5]))
    with pytest.raises(TypeError, match="freq divisible"):
        port.dnn(x[:, :, :32], x[:, :, :32], torch.tensor([0.5]))


def test_exported_trees_are_copies():
    """``convert.jax_tree_from_state_dict`` returns arrays of their own: a
    train-mode forward after the export (which moves the statistics in place)
    and a parameter update leave the exported trees as they were. They were
    numpy views of the model's tensors before, so an export taken during
    training changed under its reader."""
    port, _, _ = _models("10 bN ds pad")
    variables = convert.jax_variables_from_state_dict(port.dnn.state_dict())
    before = jax.tree.map(np.copy, variables)
    x, y, t = _inputs(33, b=2)
    port.dnn.train()
    with torch.no_grad():
        port.dnn(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(t))
        port.dnn.encoder0.conv.re.weight.add_(1.0)
    flat, want = convert.flatten_tree(variables), convert.flatten_tree(before)
    assert all(np.array_equal(flat[k], want[k]) for k in want)
    moved = convert.flatten_tree(convert.jax_variables_from_state_dict(port.dnn.state_dict()))
    assert not np.array_equal(moved["batch_stats/encoder0/norm/re/mean"],
                              want["batch_stats/encoder0/norm/re/mean"])
