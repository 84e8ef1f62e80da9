"""K6's host-side plan (``ops.upfirdn2d.fir_conv_plan``) and the index math of
its kernel (``csrc/fir_conv.cu``), on the CPU.

The plan is walked at every K6 call signature of the full-width 48 kHz net
with residual pyramids (the 12 of a B=4 evaluation and of a B=8 train step),
in float32 and bfloat16, on an H100's 232,448 bytes of shared memory a block:
the tiles cover every output pixel and channel exactly once, and within a
tile every read stays inside what the block holds. The signatures are
recorded from a narrow network at full depth (nf 8, 64 frames, batch 1) and
scaled to the full width: channels x16 (but the 4 input channels), frames x4.

The kernel's algorithm is then carried out in numpy, tile by tile as the
kernel walks it (up: the transposed convolution by parity class on the tile
plus its halo, then the separable FIR from the tile; down: the FIR tile,
then the strided taps), and held to the plain version within 1e-5 of
max|plain| (float64 against float32).
"""
import numpy as np
import pytest
import torch

from sgmse_tpu_torch import kernel_times as kt
from sgmse_tpu_torch.model import ScoreModel
from sgmse_tpu_torch.ops import upfirdn2d as ufd

SMEM = 232_448
FIR = (1, 3, 3, 1)
TOL = 1e-5
# (element size, C_in) -> the up plan's (channels a block, tile): the most channels whose
# weights, with the input and conv tiles, fit a block
UP_PLAN = {(2, 128): (64, 16, 16), (2, 256): (32, 16, 16), (4, 128): (32, 8, 16),
           (4, 256): (16, 8, 16)}


def k6_signatures(batch):
    """[(up, B, C_in, C_out, H, W)] of the K6 calls of one full-width evaluation."""
    arch, settings = kt.VARIANTS["48k_residual"]
    model = ScoreModel(arch, "ouve", nf=8, init_scale=1.0, n_fft=1534, hop_length=384,
                       **settings).dnn.eval()
    x = torch.zeros(1, 1, kt.BINS[arch], 64, dtype=torch.complex64)
    with torch.inference_mode(), kt.routed(calls=[], plain=True) as calls:
        model(x, x, torch.full((1,), 0.5))
    sigs = []
    for kind, x_shape, w_shape, taps, factor, gain, has_bias in (
            sig for name, sig in calls if name == "fir_conv"):
        assert taps == FIR and (factor, gain, has_bias) == (2, 1.0, True)
        cin = x_shape[1] if x_shape[1] == 4 else 16 * x_shape[1]
        sigs.append((kind == "up", batch, cin, 16 * w_shape[0], x_shape[2], 4 * x_shape[3]))
    return sigs


def test_signatures_are_the_residual_nets_twelve():
    sigs = k6_signatures(4)
    assert len(sigs) == 12 and sum(up for up, *_ in sigs) == 6
    assert sigs[0] == (False, 4, 4, 128, 768, 256)  # the input pyramid's first level
    assert sigs[-1] == (True, 4, 128, 128, 384, 128)  # the top up call: 768 x 256 out
    assert {c for _, _, c, _, _, _ in sigs} == {4, 128, 256}


def up_classes(th, tw):
    """The kernel's four conv-output classes of an up tile: (row parity, column
    parity, rows, columns, taps), a tap as (r, s, input row offset, column offset)."""
    out = []
    for cls in range(4):
        cy, cx = cls >> 1, cls & 1
        rows = [(1, 0)] if cy else [(0, 0), (2, 1)]
        cols = [(1, 0)] if cx else [(0, 0), (2, 1)]
        taps = [(r, s, dr, dc) for r, dr in rows for s, dc in cols]
        out.append((cy, cx, th // 2 + 1 + cy, tw // 2 + 1 + cx, taps))
    return out


def items(plan, batch):
    """The (batch row, tile, split) each block of one channel block takes, as
    the kernel walks the grid: up's persistent blocks stride over the items;
    down's clusters of ksplit blocks share a tile."""
    per_image = plan.tiles_h * plan.tiles_w
    if ufd.FIR_CONV_VARIANTS[plan.variant] == "up":
        assert plan.grid[1:] == (plan.nblocks, 1) and plan.ksplit == 1
        return [(*divmod(i, per_image), 0) for bx in range(plan.grid[0])
                for i in range(bx, batch * per_image, plan.grid[0])]
    assert plan.grid == (per_image, plan.nblocks * plan.ksplit, batch)
    return [(bz, bx, r) for bz in range(batch) for bx in range(plan.grid[0])
            for r in range(plan.ksplit)]


def split_slices(cin, element_size, ksplit):
    """The C_in slices (of 32 bytes of channels) each block of a down cluster sums."""
    slices = cin * element_size // 32
    per = -(-slices // ksplit)
    return [range(r * per, min(slices, (r + 1) * per)) for r in range(ksplit)]


def walk(plan, up, batch):
    """Every (item, row) of the plan as the kernel maps it: returns the output
    pixels each channel block writes, asserting every read inside the block's
    tiles."""
    th, tw = plan.th, plan.tw
    pixels = []
    for b, tile, split in items(plan, batch):
        oy0, ox0 = (tile // plan.tiles_w) * th, (tile % plan.tiles_w) * tw
        if up:
            xr, xc = th // 2 + 2, tw // 2 + 2
            seen = np.zeros((th + 3, tw + 3), int)
            for cy, cx, nr, nc, taps in up_classes(th, tw):
                assert -(-nr * nc // 16) <= 8  # the block's 4 x 2 row tiles of 16
                for r, s, dr, dc in taps:
                    assert 0 <= dr and nr - 1 + dr < xr and 0 <= dc and nc - 1 + dc < xc
                for i in range(nr):
                    for j in range(nc):
                        seen[2 * i + 1 - cy, 2 * j + 1 - cx] += 1
            assert (seen == 1).all()  # each conv output of the tile and its halo once
        else:
            f_rows, f_cols = 2 * th + 1, 2 * tw + 1
            for p in range(th * tw):
                py, px = divmod(p, tw)
                assert 2 * py + 2 < f_rows and 2 * px + 2 < f_cols  # the taps' reach
            # the FIR tile's reads: 4 taps past each of its pixels, inside the input tile
            assert f_rows + 3 == 2 * th + 4 and f_cols + 3 == 2 * tw + 4
        share = -(-th * tw // plan.ksplit)  # the tile's pixels this block stores
        pixels += [(b, oy0 + p // tw, ox0 + p % tw)
                   for p in range(split * share, min(th * tw, (split + 1) * share))
                   if oy0 + p // tw < plan.oh and ox0 + p % tw < plan.ow]
    return pixels


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_fits_and_covers_every_signature(batch, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    for up, b, cin, cout, h, w in k6_signatures(batch):
        plan = ufd.fir_conv_plan(up, b, cin, cout, h, w, esize, SMEM)
        assert plan.smem <= SMEM, (up, cin, h, w, plan)
        assert (plan.oh, plan.ow) == ((2 * h, 2 * w) if up else (h // 2, w // 2))
        assert plan.nblocks * plan.nb >= cout > (plan.nblocks - 1) * plan.nb
        pixels = walk(plan, up, b)
        assert len(pixels) == len(set(pixels)) == b * plan.oh * plan.ow  # each exactly once
        assert ufd.FIR_CONV_VARIANTS[plan.variant] == (
            "up" if up else "down_narrow" if cin < 16 else "down")
        if not up and cin >= 16:  # a cluster's blocks sum each slice once, and fit the card
            ranges = split_slices(cin, esize, plan.ksplit)
            assert sorted(s for r in ranges for s in r) == list(range(cin * esize // 32))
            assert plan.ksplit in (1, 2, 4, 8) and all(ranges)
        if up:
            assert (plan.nb, plan.th, plan.tw) == UP_PLAN[(esize, cin)], (esize, cin)
            assert plan.grid[0] * plan.nblocks <= 132  # one block an SM at most


def test_plan_takes_smaller_up_tiles_where_the_large_do_not_fit():
    plan = ufd.fir_conv_plan(True, 8, 256, 128, 192, 64, 4, 200_000)
    assert (plan.nb, plan.th, plan.tw) == (16, 8, 8)
    with pytest.raises(ValueError):  # 16 channels' weights alone are above the limit
        ufd.fir_conv_plan(True, 8, 256, 128, 192, 64, 4, 140_000)
    for up, cin, cout in [(True, 8, 64), (True, 24, 64), (False, 6, 64), (False, 24, 64),
                          (False, 16, 60)]:
        with pytest.raises(ValueError):
            ufd.fir_conv_plan(up, 1, cin, cout, 16, 16, 2, SMEM)


def emulate(x, w, bias, up, th, tw):
    """The kernel's algorithm in float64 numpy, tile by tile."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    f = ufd.fir_taps(FIR, up).astype(np.float64)
    oh, ow = (2 * h, 2 * wd) if up else ((h - 2) // 2 + 1, (wd - 2) // 2 + 1)
    y = np.zeros((b, cout, oh, ow))

    def tile_of(a, r0, c0, rows, cols):  # a window of x, zero outside
        out = np.zeros((b, a.shape[1], rows, cols))
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + rows, a.shape[2]), min(c0 + cols, a.shape[3])
        if rs < re and cs < ce:
            out[:, :, rs - r0:re - r0, cs - c0:ce - c0] = a[:, :, rs:re, cs:ce]
        return out

    for oy0 in range(0, oh, th):
        for ox0 in range(0, ow, tw):
            if up:
                xt = tile_of(x, oy0 // 2 - 1, ox0 // 2 - 1, th // 2 + 2, tw // 2 + 2)
                conv = np.full((b, cout, th + 3, tw + 3), np.nan)
                for cy, cx, nr, nc, taps in up_classes(th, tw):
                    acc = np.zeros((b, cout, nr, nc))
                    for r, s, dr, dc in taps:
                        acc += np.einsum("oc,bcij->boij", w[:, :, r, s],
                                         xt[:, :, dr:dr + nr, dc:dc + nc])
                    conv[:, :, 1 - cy::2, 1 - cx::2] = acc
                out = sum(f[p] * f[q] * conv[:, :, p:p + th, q:q + tw]
                          for p in range(4) for q in range(4))
            else:
                xt = tile_of(x, 2 * oy0 - 2, 2 * ox0 - 2, 2 * th + 4, 2 * tw + 4)
                xf = sum(f[a] * f[q] * xt[:, :, a:a + 2 * th + 1, q:q + 2 * tw + 1]
                         for a in range(4) for q in range(4))
                out = sum(np.einsum("oc,bcij->boij", w[:, :, r, s],
                                    xf[:, :, r:r + 2 * th - 1:2, s:s + 2 * tw - 1:2])
                          for r in range(3) for s in range(3))
            rows, cols = min(th, oh - oy0), min(tw, ow - ox0)
            y[:, :, oy0:oy0 + rows, ox0:ox0 + cols] = out[:, :, :rows, :cols]
    return y + bias[:, None, None]


@pytest.mark.parametrize("up,tile", [(True, t) for t in ufd._UP_TILES]
                         + [(False, ufd._DOWN_TILE)])
def test_kernel_algorithm_matches_plain(up, tile):
    """Odd and even sizes, several tiles with a ragged edge, the image border."""
    rng = np.random.default_rng(0)
    for h, wd in [(9, 20), (22, 7)]:
        x = rng.standard_normal((2, 16, h, wd))
        w = rng.standard_normal((8, 16, 3, 3)) * 0.2
        bias = rng.standard_normal(8)
        ref = ufd.fir_conv_plain(torch.from_numpy(x).float(), torch.from_numpy(w).float(), FIR,
                                 2, 1.0, torch.from_numpy(bias).float(), up).numpy()
        got = emulate(x, w, bias, up, *tile)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), (h, wd)
