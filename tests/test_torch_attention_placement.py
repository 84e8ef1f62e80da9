"""Where the port places attention when a model is built from a JAX config.

The JAX package places attention by the runtime frequency height and never
reads ``image_size`` (every JAX ``config.json`` says 256); its parameter tree
follows the input it is initialised with, the STFT's ``n_fft // 2 + 1`` bins.
The port builds its attention blocks at construction, so ``ScoreModel`` takes
the height from its STFT. The network here is small (nf 16, six levels of
ch_mult 1, one res-block, attention at 16) at n_fft 1022: F = 512, so the
16-row level is the sixth (``down_5_attn0``, ``up_5_attn``), where an
``image_size`` of 256 would put it at the fifth.
Tolerance: 1e-4 relative max-abs on the forward (float32 convolutions in
another order).
"""
import numpy as np
import pytest
import torch

import jax

from sgmse_tpu.model import ScoreModel as JaxScoreModel
from sgmse_tpu_torch import convert
from sgmse_tpu_torch.model import ScoreModel

NET = dict(nf=16, ch_mult=(1,) * 6, num_res_blocks=1, attn_resolutions=(16,), init_scale=1.0,
           n_fft=1022)
F_BINS, FRAMES = 512, 32


@pytest.fixture(scope="module")
def jax_model_and_variables():
    model = JaxScoreModel("ncsnpp", "ouve", **NET)
    x = np.zeros((1, 1, F_BINS, FRAMES), np.complex64)
    variables = jax.jit(model.dnn.init)(jax.random.key(3), x, x, np.full((1,), 0.5, np.float32))
    return model, jax.tree.map(np.asarray, variables)


def test_config_model_loads_jax_weights_and_matches_forward(jax_model_and_variables):
    jmodel, variables = jax_model_and_variables
    cfg = jmodel.config_dict()
    assert cfg["image_size"] == 256 and cfg["n_fft"] == 1022
    assert {"down_5_attn0", "up_5_attn"} <= set(variables["params"])
    assert not {"down_4_attn0", "up_4_attn"} & set(variables["params"])

    model = ScoreModel.from_config(cfg)
    model.dnn.load_state_dict(convert.state_dict_from_jax(variables["params"]), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    assert model.config_dict() == cfg

    rng = np.random.default_rng(5)
    shape = (2, 1, F_BINS, FRAMES)
    x, y = ((0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)))
            .astype(np.complex64) for _ in range(2))
    t = np.array([0.1, 0.7], np.float32)
    ref = np.asarray(jax.jit(jmodel.dnn.apply)(variables, x, y, t))
    with torch.no_grad():
        got = model.dnn(*(torch.from_numpy(a) for a in (x, y, t))).numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("n_fft,levels", [(510, (4,)), (1022, (5,)), (1534, ())])
def test_attention_levels_follow_the_stft(n_fft, levels):
    """The attention blocks the port builds at each n_fft (config image_size
    left at 256): at 16 rows of F = n_fft // 2 + 1 halved per level. F = 768
    never halves to 16 in six levels."""
    model = ScoreModel("ncsnpp", "ouve", **dict(NET, n_fft=n_fft))
    assert model.config_dict()["image_size"] == 256
    names = {n.split(".")[0] for n, _ in model.dnn.named_parameters()}
    assert sorted(n for n in names if n.startswith("down_") and "_attn" in n) == [
        f"down_{i}_attn0" for i in levels]
    assert sorted(n for n in names if n.startswith("up_") and n.endswith("_attn")) == [
        f"up_{i}_attn" for i in levels]
