"""The host side of the scene-assembly (K3, ``csrc/scene.cu``) and
gradient-gather (K4, ``csrc/grad.cu``) kernels, on the CPU.

- ``grad_gather`` on the unpadded gradient with pad 0 gives the same bits
  as on the gradient zero-padded by P with pad P (the fit now passes the
  gradient unpadded, in place), for a contiguous gradient and for the
  strided crop of the inverse FFT that the engine passes;
- the launch geometries (``kernels.scene_geometry``,
  ``kernels.grad_geometry``) cover each scene pixel and each window pixel
  once, the gradient's staging copy covers each value once with aligned
  16-byte copies, the shared bytes stay within a block's budget, and the
  route follows the documented rule;
- the stated difference of the plain scene assembly: an inactive slot
  holding NaN.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scarlet_tpu_torch.ops import fft as tfft
from scarlet_tpu_torch.ops import kernels as kn


def _components(rng, B, K, C, H, W, hb, wb, reach):
    """Seeded seds, morphologies and origins whose boxes reach up to
    ``reach`` pixels past every scene edge; one box wholly off the scene."""
    seds = rng.uniform(0.1, 2, (B, K, C)).astype(np.float32)
    morphs = rng.uniform(0, 1, (B, K, hb, wb)).astype(np.float32)
    oy = rng.integers(-hb - reach // 2, H + reach // 2, (B, K, 1))
    ox = rng.integers(-wb - reach // 2, W + reach // 2, (B, K, 1))
    origins = np.concatenate([oy, ox], -1).astype(np.int32)
    origins[0, 0] = (-hb - 3, 2)                 # above the scene
    return [torch.from_numpy(x) for x in (seds, morphs, origins)]


def _gradient(rng, B, C, H, W, layout):
    """A (B, C, H, W) gradient: contiguous, or the centered crop of a
    larger array, as ``fft.inverse_transform`` returns it."""
    if layout == "contiguous":
        return torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(
            np.float32))
    full = torch.from_numpy(rng.normal(size=(B, C, H + 31, W + 26)).astype(
        np.float32))
    g = tfft.centered(full, (H, W), axes=(-2, -1))
    assert not g.is_contiguous() and g.stride(-1) == 1
    return g


@pytest.mark.parametrize("layout", ["contiguous", "centered"])
@pytest.mark.parametrize("box", [21, 59, (31, 21)])
@pytest.mark.parametrize("pad", [8, 31])
def test_unpadded_gradient_equals_padded_bitwise(layout, box, pad):
    hb, wb = (box, box) if isinstance(box, int) else box
    rng = np.random.default_rng(hb * 100 + pad)
    B, K, C, H, W = 3, 6, 5, 58, 48
    seds, morphs, origins = _components(rng, B, K, C, H, W, hb, wb, 2 * pad)
    grad = _gradient(rng, B, C, H, W, layout)
    gpad = F.pad(grad, (pad,) * 4)
    want = kn.grad_gather_plain(gpad, seds, morphs, origins, pad)
    for got in (kn.grad_gather_plain(grad, seds, morphs, origins, 0),
                kn.grad_gather(grad, seds, morphs, origins, 0)):
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    # the box wholly off the scene reads only zeros
    assert not want[1][0, 0].any() and not want[0][0, 0].any()


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------
def _scene_cover(g, H, W):
    """The output pixels each thread of the scene kernel's map writes
    (csrc/scene.cu ``scene_kernel``): counts (H, W)."""
    seen = np.zeros((H, W), int)
    t = np.arange(g.TX * g.TY)
    ty, tx = t // g.TX, t % g.TX
    for band in range(g.bands):
        y0 = band * g.TY
        y = y0 + ty
        for tile in range(g.tiles):
            xs0 = tile * g.TX * g.XV
            x0 = xs0 + tx * g.XV
            on = (y < min(H, y0 + g.TY)) & (x0 < min(W, xs0 + g.TX * g.XV))
            for v in range(g.XV):
                np.add.at(seen, (y[on], x0[on] + v), 1)
    return seen


def _grad_cover(g, K, hb, wb):
    """The window pixels each lane of the gradient kernel's walk takes
    (csrc/grad.cu ``grad_kernel``): counts (K, hb, wb)."""
    warps = g.threads // 32
    seen = np.zeros((K, hb, wb), int)
    for group in range(g.groups):
        k0 = group * g.G
        for j in range(min(g.G, K - k0)):
            for w in range(warps):
                ys = np.arange((w - (k0 + j) * hb % warps + warps) % warps,
                               hb, warps)
                for lane in range(32):
                    xs = np.arange(lane, wb, 32)
                    seen[k0 + j][np.ix_(ys, xs)] += 1
    return seen


def _stage_cover(C, H, W, shift, vec, warps=kn.GRAD_THREADS // 32):
    """The gradient values the staging copy (csrc/grad.cu ``stage_grad``)
    moves, as counts (C, H, W), and whether every 16-byte copy is aligned
    on both sides (shared index ``shift + (c * H + y) * W + x``; global
    offset ``shift`` plus strides that are multiples of 4)."""
    seen = np.zeros((C, H, W), int)
    aligned = True
    items = W // 4 + (shift != 0) if vec else W
    rows = 32 // items if items <= 32 else 1
    for w in range(warps):
        for lane in range(32):
            sub = lane // items if items <= 32 else 0
            q0 = lane - sub * items if items <= 32 else lane
            if sub >= rows:
                continue
            for c in range(C):
                for y in range(w * rows + sub, H, warps * rows):
                    base = shift + (c * H + y) * W
                    for q in range(q0, items, 32):
                        if not vec:
                            seen[c, y, q] += 1
                            continue
                        x0 = 4 * q - shift
                        if x0 >= 0 and x0 + 4 <= W:
                            seen[c, y, x0:x0 + 4] += 1
                            aligned &= (base + x0) % 4 == 0
                        else:
                            seen[c, y, max(x0, 0):min(x0 + 4, W)] += 1
    return seen, aligned


# scenes from the fit's 58 x 48 to one above the staging budget; boxes
# 21-69 and non-square; C 1-40 (past 8: the kernels' grouped
# instantiations) and K 1-64 across the cases
SCENES = [(58, 48), (57, 47), (118, 108), (160, 160)]
CASES = [(21, 21, 1, 1), (41, 41, 5, 16), (59, 59, 5, 16), (69, 69, 8, 40),
         (21, 31, 3, 64), (31, 21, 8, 7), (9, 200, 2, 3), (59, 61, 5, 33),
         (59, 59, 10, 16), (21, 21, 16, 16), (31, 31, 40, 8)]


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("hb,wb,C,K", CASES)
def test_gather_geometry_covers_each_pixel_once(hb, wb, C, K, scene):
    H, W = scene
    for B in (1, 4, 128):
        sg = kn.scene_geometry(B, K, C, H, W)
        assert (_scene_cover(sg, H, W) == 1).all()
        assert sg.threads % 32 == 0 and sg.threads <= kn.SCENE_THREADS
        assert sg.TX * sg.TY <= sg.threads and W % sg.XV == 0
        assert sg.XV == (4 if W % 4 == 0 else 2 if W % 2 == 0 else 1)
        assert sg.blocks == B * sg.bands * sg.tiles
        assert sg.smem == 4 * K * (3 + C) <= kn.SMEM_LIMIT

        gg = kn.grad_geometry(B, K, C, H, W, hb, wb)
        assert (_grad_cover(gg, K, hb, wb) == 1).all()
        assert 1 <= gg.G <= K
        assert gg.groups == -(-K // gg.G) and gg.blocks == B * gg.groups
        assert gg.smem <= kn.SMEM_LIMIT
        assert gg.blocks_per_sm * (gg.smem + kn.BLOCK_SMEM_RESERVED) \
            <= kn.SM_SMEM or gg.blocks_per_sm == 1
        # the documented route: staged exactly where two blocks, each with
        # the gradient, two morphologies, one component's seds, origins
        # and g_sed sums, fit an SM's shared memory
        stage = 4 * (C * H * W + 3) + 4 * -(-C * 8 // 4) * 4 \
            + 4 * -(-C // 4) * 4 + 16 + 8 * ((hb * wb + 6) // 4 * 4)
        assert gg.staged == (2 * (stage + 1024) <= kn.SM_SMEM)
        assert gg.blocks_per_sm >= 2 or not gg.staged


def test_grad_geometry_at_the_fit_shapes():
    """128 blends of 15 components on 5 x 58 x 48, box 59: the staged route,
    8 components a block, two blocks (256 in all) for the 132 x 2 the card
    holds at once; a gradient padded by the fit's 24 takes the direct
    route, 4 components a block, 4 blocks per SM."""
    g = kn.grad_geometry(128, 15, 5, 58, 48, 59, 59)
    assert g.staged and (g.G, g.groups, g.blocks) == (8, 2, 256)
    assert g.blocks_per_sm == 2
    assert g.smem == 4 * (320 + 40 + 16 + 2 * 3484 + 5 * 58 * 48 + 3)
    d = kn.grad_geometry(128, 15, 5, 58 + 48, 48 + 48, 59, 59)
    assert not d.staged and (d.G, d.groups, d.blocks_per_sm) == (4, 4, 4)
    assert not kn.grad_geometry(4, 16, 5, 160, 160, 59, 59).staged
    s = kn.scene_geometry(128, 15, 5, 58, 48)
    assert (s.XV, s.TX, s.TY, s.bands, s.threads) == (4, 12, 10, 6, 128)


def test_gather_geometry_past_eight_bands():
    """At 10 and 16 bands the fit's shapes (128 blends of 16 components,
    box 59, 58 x 48) take K4's direct route, whose blocks still fill 4 a
    SM; a small scene keeps the staged route at 40 bands."""
    for C in (10, 16):
        g = kn.grad_geometry(128, 16, C, 58, 48, 59, 59)
        assert not g.staged and g.blocks_per_sm == 4
        assert kn.scene_geometry(128, 16, C, 58, 48).smem == 4 * 16 * (3 + C)
    assert kn.grad_geometry(4, 16, 40, 24, 24, 21, 21).staged


def test_gather_geometry_raises_past_shared_memory():
    """What is left of a limit: K3's origins and seds and K4's one-
    component block must fit a block's shared memory; past it the
    geometry raises ValueError naming the bytes."""
    with pytest.raises(ValueError, match="240024 B of shared memory"):
        kn.scene_geometry(1, 2, 30000, 4, 4)
    assert kn.scene_geometry(1, 2, 29000, 4, 4).smem <= kn.SMEM_LIMIT
    with pytest.raises(ValueError, match="234016 B of shared memory"):
        kn.grad_geometry(1, 1, 1, 8, 8, 171, 171)
    assert kn.grad_geometry(1, 1, 1, 8, 8, 170, 170).smem <= kn.SMEM_LIMIT


@pytest.mark.parametrize("C", [9, 10, 16, 40])
def test_grouped_band_walk_keeps_the_plain_bits(C):
    """The kernels' order past 8 bands, modelled in float32 numpy: K3's
    bands in groups of 8, each band's sum over the components in
    ascending k; K4's g_morph carried from one group to the next through
    the value stored between them, each product and sum rounded on its
    own, and g_sed per (component, band).  Equal to the plain versions
    bit for bit (g_sed to float32 roundoff of the hw-term sum)."""
    rng = np.random.default_rng(C)
    B, K, H, W, hb = 2, 3, 20, 18, 9
    seds, morphs, origins = _components(rng, B, K, C, H, W, hb, hb, 4)
    origins = origins.clamp(-hb + 1, 16)
    on = torch.ones(B, K, dtype=torch.bool)
    scene = np.zeros((B, C, H, W), np.float32)
    s, m, o = seds.numpy(), morphs.numpy(), origins.numpy()
    for b in range(B):
        for c0 in range(0, C, 8):
            for c in range(c0, min(C, c0 + 8)):
                for k in range(K):
                    y0, x0 = o[b, k]
                    for y in range(max(0, y0), min(H, y0 + hb)):
                        for x in range(max(0, x0), min(W, x0 + hb)):
                            scene[b, c, y, x] = np.float32(
                                scene[b, c, y, x] + np.float32(
                                    s[b, k, c] * m[b, k, y - y0, x - x0]))
    ref = kn.scene_assembly_plain(seds, morphs, origins, on, (C, H, W), hb)
    assert torch.equal(torch.from_numpy(scene), ref)

    g = rng.normal(size=(B, C, H, W)).astype(np.float32)
    rs, rm = kn.grad_gather_plain(torch.from_numpy(g), seds, morphs,
                                  origins, 0)
    win = np.zeros((B, K, C, hb, hb), np.float32)
    for b in range(B):
        for k in range(K):
            y0, x0 = o[b, k]
            for y in range(hb):
                for x in range(hb):
                    if 0 <= y0 + y < H and 0 <= x0 + x < W:
                        win[b, k, :, y, x] = g[b, :, y0 + y, x0 + x]
    gm = np.zeros((B, K, hb, hb), np.float32)
    for c0 in range(0, C, 8):
        stored = gm.copy()                  # what the last group stored
        acc = stored
        for c in range(c0, min(C, c0 + 8)):
            t = (s[:, :, c, None, None] * win[:, :, c]).astype(np.float32)
            acc = t if c == 0 else (acc + t).astype(np.float32)
        gm = acc
    assert np.array_equal(gm, rm.numpy())
    gs = (win * m[:, :, None]).astype(np.float64).sum(axis=(-2, -1))
    assert np.abs(gs - rs.numpy()).max() <= 1e-5 * np.abs(
        win * m[:, :, None]).sum(axis=(-2, -1)).max()


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("H,W", [(58, 48), (57, 47), (5, 12), (3, 200),
                                 (7, 132)])
def test_staging_copy_covers_each_value_once(H, W, shift):
    for vec in ((False, True) if W % 4 == 0 else (False,)):
        if not vec and shift:
            continue               # 4-byte copies run unshifted
        seen, aligned = _stage_cover(3, H, W, shift, vec)
        assert (seen == 1).all()
        assert aligned


@pytest.mark.parametrize("n", [1, 3, 4, 5, 9, 21 * 21, 59 * 59])
def test_span_copy_covers_each_value_once(n):
    """csrc/grad.cu ``stage_span`` (the morphology buffers): aligned
    groups of 4 as 16-byte copies, both sides aligned, each value once,
    for every offset of the source within 16 bytes."""
    for shift in range(4):
        seen = np.zeros(n, int)
        items = (shift + n + 3) // 4
        for q in range(items):
            x0 = 4 * q - shift
            if x0 >= 0 and x0 + 4 <= n:
                assert (shift + x0) % 4 == 0 and (shift + x0) == 4 * q
                seen[x0:x0 + 4] += 1
            else:
                seen[max(x0, 0):min(x0 + 4, n)] += 1
        assert (seen == 1).all()
        assert (n + 6) // 4 * 4 >= n + shift


def test_scene_plain_inactive_nan_is_the_stated_difference():
    """An inactive slot adds (sed * morph) * 0 at the padding's corner in
    the plain version: +-0 for finite values, NaN where its morphology is
    NaN and the parked box reaches into the scene (hb > pad).  The kernel
    skips inactive slots, which is the plain result without the slot."""
    rng = np.random.default_rng(9)
    C, H, W, hb, pad = 5, 58, 48, 21, 8
    seds, morphs, origins = _components(rng, 1, 4, C, H, W, hb, hb, pad)
    origins = origins.clamp(1 - pad, 20)
    on = torch.tensor([[True, False, True, True]])
    ref = kn.scene_assembly_plain(seds, morphs, origins, on, (C, H, W), pad)
    keep = [0, 2, 3]
    without = kn.scene_assembly_plain(
        seds[:, keep], morphs[:, keep], origins[:, keep], on[:, keep],
        (C, H, W), pad)
    assert torch.equal(ref, without)
    morphs[0, 1] = float("nan")
    ref = kn.scene_assembly_plain(seds, morphs, origins, on, (C, H, W), pad)
    nan = torch.isnan(ref)
    assert nan[..., :hb - pad, :hb - pad].all() and nan.sum() == \
        C * (hb - pad) ** 2
    assert torch.equal(ref[~nan], without[~nan])
