"""K2b's host-side plan (``ops.group_norm.bwd_plan``) at every K2b call
signature of the flagship and 48 kHz train steps (T=256 frames, nf 128) at
the JAX CLI's B=8 and at the Schroedinger-bridge recipe's B=16, in float32
and bfloat16, on a 132-SM H100.

The signatures are recorded from a narrow network at full depth (nf 8, 64
frames, batch 1: K2b's signatures are the forward norms') and scaled to the
full width: channels x16, frames x4, batch 8 or 16. The plan is walked as the kernel
walks it (wave w, tile slot s, range j: tile w * tpw + s, pixels [j * ppb,
(j + 1) * ppb)), and must cover every (b, c, pixel) exactly once, with bands of
whole groups and whole 16-byte vectors and no block asking for more shared
memory than a block may have.
"""
import pytest
import torch

from sgmse_tpu_torch import kernel_times as kt
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.ops import group_norm as gn

SMS, SMEM = 132, 232_448
STFT = {"ncsnpp": {}, "ncsnpp_48k": dict(n_fft=1534, hop_length=384)}


def train_signatures(backbone, batch):
    """{(B, C, H, W)} of the K2b calls of a full-width train step at ``batch``."""
    model = ScoreModel(backbone, "ouve", nf=8, init_scale=1.0, **STFT[backbone]).dnn.eval()
    x = torch.zeros(1, 1, kt.BINS[backbone], 64, dtype=torch.complex64)
    with torch.inference_mode(), kt.routed(calls=[], plain=True) as calls:
        model(x, x, torch.full((1,), 0.5))
    return sorted({(batch, 16 * s[0][1], s[0][2], 4 * s[0][3])
                   for n, s in calls if n == "group_norm_act"})


def covered_once(plan, b, hw, c):
    """Walk the plan as the kernel does: each (tile, pixel) exactly once."""
    nbands = c // plan.band
    seen = {}
    for w in range(plan.waves):
        for slot in range(plan.tpw):
            tile = w * plan.tpw + slot
            if tile >= b * nbands:
                continue
            for j in range(plan.nbt):
                p0, p1 = j * plan.ppb, min((j + 1) * plan.ppb, hw)
                seen.setdefault(tile, []).append((p0, p1))
    assert sorted(seen) == list(range(b * nbands))  # every (b, band) tile once
    for ranges in seen.values():
        ranges = [r for r in sorted(ranges) if r[0] < r[1]]
        assert ranges[0][0] == 0 and ranges[-1][1] == hw
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("batch", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backbone", ["ncsnpp", "ncsnpp_48k"])
def test_plan_covers_every_train_signature(backbone, dtype, batch):
    esize = torch.empty((), dtype=dtype).element_size()
    sigs = train_signatures(backbone, batch)
    assert {c for _, c, _, _ in sigs} == {128, 256, 384, 512}
    for b, c, h, w in sigs:
        groups = gn.num_groups_for(c)
        plan = gn.bwd_plan(b, h * w, c, groups, esize, SMS, SMEM)
        cpg = c // groups
        assert plan.band % cpg == 0 and (plan.band * esize) % 16 == 0 and c % plan.band == 0
        assert plan.band * esize >= 128  # a whole cache line of each pixel
        assert plan.smem <= SMEM and plan.grid == plan.tpw * plan.nbt <= SMS
        assert 1 <= plan.stage_pix <= plan.ppb and 0 <= plan.pf_pix <= plan.stage_pix
        covered_once(plan, b, h * w, c)
        # What a wave reads twice (its blocks' tails) stays within the L2 share,
        # but where one tile alone is larger (the 48 kHz top level, 768 x 256
        # pixels), which takes every SM.
        tail = plan.grid * (plan.ppb - plan.stage_pix) * 2 * plan.band * esize
        alone = plan.tpw == 1 and plan.grid == SMS
        assert tail <= gn.BWD_L2_TAIL_BYTES or alone, (b, c, h, w)
        assert alone == (h == 768), (b, c, h, w)


def test_plan_makes_small_calls_one_wave_and_large_ones_several():
    """At B=8 float32: one wave, with a whole tile in each block, at 16x16 and
    under; one wave up to 32x32; several for 256 and 512 channels at 64x64 and
    every call above; two 16 MiB tiles a wave at 256x256."""
    plan = lambda c, hw: gn.bwd_plan(8, hw, c, gn.num_groups_for(c), 4, SMS, SMEM)
    for c, hw in [(512, 16 * 16), (256, 16 * 16), (512, 4 * 4)]:
        assert plan(c, hw).waves == 1 and plan(c, hw).nbt == 1
    for c, hw in [(256, 32 * 32), (512, 32 * 32), (128, 64 * 64)]:
        assert plan(c, hw).waves == 1
    for c, hw in [(256, 64 * 64), (512, 64 * 64), (128, 128 * 128), (128, 256 * 256)]:
        assert plan(c, hw).waves > 1
    assert plan(256, 256 * 256).waves == 32 and plan(256, 256 * 256).tpw == 2


def test_band_is_whole_groups_of_a_cache_line():
    assert [gn.bwd_band(c, gn.num_groups_for(c), 4) for c in (128, 256, 384, 512)] == [
        32, 32, 48, 32]
    assert [gn.bwd_band(c, gn.num_groups_for(c), 2) for c in (128, 256, 384, 512)] == [
        64, 64, 96, 64]
    assert gn.bwd_band(16, gn.num_groups_for(16), 4) == 16  # narrower than a line: all of C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_at_b16_takes_the_waves_of_twice_the_tiles(dtype):
    """The bridge recipe's B=16 step against the B=8 one, signature by
    signature: the same band; twice the tiles take no fewer waves and at most
    twice as many, plus one where the tiles are evened out over the waves;
    no wave is empty; at most one tile per SM; the calls of 16x16 and under in
    as few waves as the SMs allow."""
    esize = torch.empty((), dtype=dtype).element_size()
    for _, c, h, w in train_signatures("ncsnpp", 16):
        groups = gn.num_groups_for(c)
        p8, p16 = (gn.bwd_plan(b, h * w, c, groups, esize, SMS, SMEM) for b in (8, 16))
        tiles = 16 * (c // p16.band)
        assert p16.band == p8.band and p16.tpw <= SMS
        assert p8.waves <= p16.waves <= 2 * p8.waves + 1, (c, h, w, p8, p16)
        assert (p16.waves - 1) * p16.tpw < tiles <= p16.waves * p16.tpw, (c, h, w, p16)
        if h * w <= 16 * 16:  # as few waves as the SMs allow (float32 512 x 16^2: two)
            assert p16.waves == -(-tiles // SMS), (c, h, w, p16)
