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
- K4's tiled route modelled in float32 numpy, block by block and lane by
  lane (tiles, band groups, the order of each sum): g_morph bit for bit
  with the plain version, g_sed the same bits whatever the batch size,
  tile rows and band groups;
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
    (csrc/grad.cu ``grad_kernel_staged`` or ``grad_kernel_tiled``, whose
    tiles only split each warp's rows): counts (K, hb, wb)."""
    warps = g.threads // 32
    seen = np.zeros((K, hb, wb), int)
    for group in range(g.groups):
        k0 = group * g.G
        for w in range(warps):
            if g.staged:
                comps = range(min(g.G, K - k0))
            else:
                comps = [w // g.R] if w // g.R < min(g.G, K - k0) else []
            for j in comps:
                if g.staged:
                    ys = np.arange((w - (k0 + j) * hb % warps + warps)
                                   % warps, hb, warps)
                else:
                    ys = np.arange(w % g.R, hb, g.R)
                for lane in range(32):
                    xs = np.arange(lane, wb, 32)
                    seen[k0 + j][np.ix_(ys, xs)] += 1
    return seen


def _first_row(y0, r, R):
    return y0 + ((r - y0 % R) % R + R) % R


def _fma(a, b, c):
    """A float32 fused multiply-add (the product is exact in float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _warp_sum(v):
    """csrc/grad.cu ``warp_sum``: lane 0's value after the shuffle tree
    (a lane whose source is out of range reads its own value)."""
    v = v.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = (v + np.concatenate([v[off:], v[32 - off:]])).astype(np.float32)
    return v[0]


def _tile_model(grad, seds, morphs, origins, pad, geo):
    """csrc/grad.cu ``grad_kernel_tiled`` in float32 numpy, block by block,
    warp by warp and lane by lane: the row tiles each block stages (each walked
    gradient row and morphology row must lie in the current tile), each
    band group's walk of a window (rows outside the gradient first), the
    g_morph chain over the bands carried through the stored value, one
    fused g_sed chain a lane and band (the rows outside the gradient add 0
    to it once, or NaN), each warp's shuffle tree and the R warps of a
    component in order.  Returns (g_seds, g_morphs)."""
    grad, seds, morphs = (np.asarray(x, np.float32)
                          for x in (grad, seds, morphs))
    org = np.asarray(origins, np.int64) + pad
    B, C, H, W = grad.shape
    K, hb, wb = morphs.shape[1:]
    R, G, TR, NB = geo.R, geo.G, geo.tile_rows, geo.band_group
    g_seds = np.zeros((B, K, C), np.float32)
    g_morphs = np.zeros((B, K, hb, wb), np.float32)
    lanes = np.arange(32)
    for b in range(B):
        for k0 in range(0, K, G):
            n = min(G, K - k0)
            spans = [(max(o, 0), min(o + hb, H)) for o in org[b, k0:k0 + n, 0]]
            spans = [sp for sp in spans if sp[0] < sp[1]]
            ylo = min((sp[0] for sp in spans), default=H)
            yhi = max((sp[1] for sp in spans), default=0)
            tiles = -(-(yhi - ylo) // TR) if ylo < yhi else 0
            zeros = {}
            for c0 in range(0, C, NB):
                nb = min(NB, C - c0)
                sums = {}
                for w in range(8):
                    j, r = divmod(w, R)
                    if j >= n:
                        continue
                    k = k0 + j
                    oy, ox = org[b, k]
                    ya = min(max(-oy, 0), hb)
                    yb = max(min(H - oy, hb), ya)
                    s = seds[b, k, c0:c0 + nb]
                    # rows outside the gradient: g_morph continues the
                    # chain of sed_c * 0, g_sed gains 0 * m (NaN if m is)
                    zero = zeros.get(k, np.float32(0))
                    for c in range(nb):
                        t = np.float32(s[c] * np.float32(0))
                        zero = t if c0 == 0 and c == 0 else np.float32(
                            zero + t)
                    zeros[k] = zero
                    out = [y for y in range(_first_row(0, r, R), ya, R)]
                    out += [y for y in range(_first_row(yb, r, R), hb, R)]
                    nonfinite = np.float32(0)
                    for y in out:
                        g_morphs[b, k, y] = zero
                        for m in morphs[b, k, y]:
                            nonfinite = _fma(0.0, m, nonfinite)
                    rows = []
                    for t in range(tiles):
                        r0 = ylo + t * TR
                        r1 = min(r0 + TR, yhi)
                        ys, ye = max(ya, r0 - oy), min(yb, r1 - oy)
                        for y in range(_first_row(ys, r, R), ye, R):
                            assert r0 <= oy + y < r1 and ys <= y < ye
                            rows.append((y, t))
                    part = np.zeros((nb, 32), np.float32) + nonfinite
                    for y, t in rows:
                        gy = oy + y
                        for x0 in range(0, wb, 32):
                            x = x0 + lanes
                            live = x < wb
                            gx = ox + x
                            inside = live & (gx >= 0) & (gx < W)
                            m = np.where(live, morphs[b, k, y,
                                                      np.minimum(x, wb - 1)],
                                         0).astype(np.float32)
                            acc = g_morphs[b, k, y, np.minimum(x, wb - 1)]
                            for c in range(nb):
                                g = np.where(inside, grad[
                                    b, c0 + c, min(max(gy, 0), H - 1),
                                    np.clip(gx, 0, W - 1)], 0).astype(
                                        np.float32)
                                term = (s[c] * g).astype(np.float32)
                                acc = term if c0 == 0 and c == 0 else (
                                    acc + term).astype(np.float32)
                                part[c] = [_fma(g[i], m[i], part[c][i])
                                           for i in range(32)]
                            g_morphs[b, k, y, x[live]] = acc[live]
                    sums[w] = [_warp_sum(part[c]) for c in range(nb)]
                for j in range(n):
                    for c in range(nb):
                        v = sums[j * R][c]
                        for q in range(1, R):
                            v = np.float32(v + sums[j * R + q][c])
                        g_seds[b, k0 + j, c0 + c] = v
    return g_seds, g_morphs


def _stage_cover(C, H, W, shift, vec, warps=kn.GRAD_THREADS // 32):
    """The gradient values the staged route's copy moves, as counts (C, H,
    W), and whether every 16-byte copy is aligned on both sides: the whole
    plane (csrc/grad.cu ``stage_grad``: shared index ``shift + (c * H + y)
    * W + x``, each warp the same rows of every band); global offset
    ``shift`` plus strides that are multiples of 4."""
    seen = np.zeros((C, H, W), int)
    aligned = True
    items = W // 4 + (shift != 0) if vec else W
    per = 32 // items if items <= 32 else 1
    for w in range(warps):
        for lane in range(32):
            sub = lane // items if items <= 32 else 0
            q0 = lane - sub * items if items <= 32 else lane
            if sub >= per:
                continue
            for c, y in [(c, y) for c in range(C)
                         for y in range(w * per + sub, H, warps * per)]:
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
        assert 1 <= gg.G <= max(K, 8 // gg.R if gg.R else 1)
        assert gg.groups == -(-K // gg.G) and gg.blocks == B * gg.groups
        assert gg.smem <= kn.SMEM_LIMIT
        assert gg.blocks_per_sm * (gg.smem + kn.BLOCK_SMEM_RESERVED) \
            <= kn.SM_SMEM or gg.blocks_per_sm == 1
        # the documented route: staged exactly where C <= 8 and two
        # blocks, each with the gradient, two morphologies, one
        # component's seds, origins and g_sed sums, fit an SM's shared
        # memory; tiled elsewhere, with R and G set by K alone
        stage = 4 * (C * H * W + 3) + 4 * -(-C * 8 // 4) * 4 \
            + 4 * -(-C // 4) * 4 + 16 + 8 * ((hb * wb + 6) // 4 * 4)
        assert gg.staged == (C <= 8 and 2 * (stage + 1024) <= kn.SM_SMEM)
        assert gg.blocks_per_sm >= 2 or not gg.staged
        if not gg.staged:
            R = 8 if K == 1 else 4 if K == 2 else 2 if K <= 4 else 1
            assert gg.R * gg.G == 8
            assert gg.R == (max(R, 4) if wb > 64 else R)
            assert gg.band_group == min(C, 64)
            assert 1 <= gg.tile_rows <= min(16, H)


def test_grad_geometry_at_the_fit_shapes():
    """128 blends of 15 components on 5 x 58 x 48, box 59: the staged route,
    8 components a block, two blocks (256 in all) for the 132 x 2 the card
    holds at once; a gradient padded by the fit's 24 takes the tiled
    route: one warp a component, 8 a block, 2 blocks an SM with tiles of
    14 rows of all 5 bands."""
    g = kn.grad_geometry(128, 15, 5, 58, 48, 59, 59)
    assert g.staged and (g.G, g.groups, g.blocks) == (8, 2, 256)
    assert g.blocks_per_sm == 2 and g.route == "staged"
    assert g.smem == 4 * (320 + 40 + 16 + 2 * 3484 + 5 * 58 * 48 + 3)
    d = kn.grad_geometry(128, 15, 5, 58 + 48, 48 + 48, 59, 59)
    assert not d.staged and d.route == "tiled"
    assert (d.G, d.groups, d.blocks_per_sm, d.R) == (8, 2, 2, 1)
    assert (d.tile_rows, d.band_group) == (14, 5)
    # the mbarriers, g_sed sums, origins, two tiles of 5 x 14 row slots of
    # 100 floats, two sets of 8 morphology spans of 14 rows
    assert d.smem == 4 * (4 + 40 + 16 + 2 * 5 * 14 * 100
                          + 2 * 8 * (14 * 59 + 3 + 3))
    assert not kn.grad_geometry(4, 16, 5, 160, 160, 59, 59).staged
    s = kn.scene_geometry(128, 15, 5, 58, 48)
    assert (s.XV, s.TX, s.TY, s.bands, s.threads) == (4, 12, 10, 6, 128)


def test_gather_geometry_past_eight_bands():
    """At 8, 10, 16 and 40 bands the fit's shapes (128 blends of 16
    components, box 59, 58 x 48) take K4's tiled route: every band in one
    walk of each window, 2 blocks an SM of one warp a component; more
    bands mean shorter tiles.  A small scene past 8 bands is tiled too,
    its whole gradient one tile."""
    rows = {}
    for C in (8, 10, 16, 40):
        g = kn.grad_geometry(128, 16, C, 58, 48, 59, 59)
        assert g.route == "tiled" and g.band_group == C
        assert (g.G, g.groups, g.blocks_per_sm, g.R) == (8, 2, 2, 1)
        rows[C] = g.tile_rows
        assert kn.scene_geometry(128, 16, C, 58, 48).smem == 4 * 16 * (3 + C)
    assert rows == {8: 16, 10: 14, 16: 11, 40: 5}
    assert kn.grad_geometry(128, 16, 7, 58, 48, 59, 59).staged
    small = kn.grad_geometry(4, 16, 40, 24, 24, 21, 21)
    assert small.route == "tiled" and small.tile_rows == 16
    assert small.band_group == 40


def test_gather_geometry_raises_past_shared_memory():
    """K3's origins and seds must fit a block's shared memory.  K4 takes
    every box (its tiled route streams the gradient and the morphologies
    by rows): boxes 81 and 171-1024 on scenes of their size, at 5 and 40
    bands.  What is left of a limit: one row of one band of the gradient,
    twice, beside a row of each window; past it the geometry raises
    ValueError naming the bytes."""
    with pytest.raises(ValueError, match="240024 B of shared memory"):
        kn.scene_geometry(1, 2, 30000, 4, 4)
    assert kn.scene_geometry(1, 2, 29000, 4, 4).smem <= kn.SMEM_LIMIT
    for B, K, C, S, box in ((32, 16, 5, 80, 81), (4, 4, 5, 170, 171),
                            (2, 2, 5, 200, 201), (1, 1, 5, 256, 256),
                            (1, 1, 40, 256, 256), (1, 1, 5, 1023, 1024),
                            (1, 1, 40, 1023, 1024)):
        g = kn.grad_geometry(B, K, C, S, S, box, box)
        assert g.route == "tiled" and g.smem <= kn.SMEM_LIMIT
        assert g.tile_rows >= 1 and 1 <= g.band_group <= C
    # 40 bands of a 1023 px row do not fit twice: two band groups
    assert kn.grad_geometry(1, 1, 40, 1023, 1023, 1024, 1024).band_group \
        < 40
    with pytest.raises(ValueError, match="240128 B of shared memory"):
        kn.grad_geometry(1, 1, 1, 1, 30000, 1, 1)
    assert kn.grad_geometry(1, 1, 1, 1, 29000, 1, 1).smem <= kn.SMEM_LIMIT


@pytest.mark.parametrize("C", [9, 10, 16, 40])
def test_grouped_band_walk_keeps_the_plain_bits(C):
    """The kernels' order past 8 bands, modelled in float32 numpy: K3's
    bands in groups of 8, each band's sum over the components in
    ascending k; K4's tiled route in band groups of 8 (``_tile_model``),
    g_morph carried from one group to the next through the value stored
    between them.  Equal to the plain versions bit for bit (g_sed to
    1e-5 of sum |g * morph|)."""
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

    g = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(np.float32))
    rs, rm = kn.grad_gather_plain(g, seds, morphs, origins, 0)
    gs, gm = _tile_model(g, seds, morphs, origins, 0,
                         _tiled(B, K, C, 8, hb))
    assert np.array_equal(gm, rm.numpy())
    scale = kn.grad_gather_plain(g.abs(), seds, morphs, origins, 0)[0]
    assert np.all(np.abs(gs - rs.numpy()) <= 1e-5 * scale.numpy())


# (B, K, C, (H, W), (hb, wb), pad, band group): one warp a component (K >
# 4), two (K = 3, 4), four and eight; 2-20 bands, one band group or
# several; boxes past the scene, padded gradients; non-square boxes
TILE_CASES = [(2, 9, 3, (20, 18), (9, 9), 0, None),
              (2, 3, 10, (16, 22), (11, 7), 0, None),
              (1, 2, 5, (12, 12), (13, 13), 3, None),
              (1, 1, 20, (9, 11), (10, 10), 0, None),
              (2, 5, 12, (14, 14), (9, 9), 2, 5)]


def _tiled(B, K, C, nb, wb, tile_rows=4):
    """A tiled-route geometry for the model (the shared bytes unused)."""
    R = kn._warps_per_component(K, wb)
    G = 8 // R
    return kn.GradGeometry(False, G, -(-K // G), B * -(-K // G), 256, 0, 1,
                           R, tile_rows, nb)


@pytest.mark.parametrize("B,K,C,scene,box,pad,nb", TILE_CASES)
def test_tiled_route_model_keeps_the_plain_bits(B, K, C, scene, box, pad,
                                                nb):
    """K4's tiled route, modelled lane by lane (``_tile_model``), gives
    g_morph bit for bit with the plain version and g_sed within 1e-5 of
    sum |g * morph|; its g_sed is the same bits with other tile rows,
    band groups and batch sizes (each sum's order follows the
    component, not the block's tiles or the batch)."""
    (H, W), (hb, wb) = scene, box
    rng = np.random.default_rng(C * 100 + K)
    seds, morphs, origins = _components(rng, B, K, C, H, W, hb, wb, 4)
    grad = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(
        np.float32))
    gpad = F.pad(grad, (pad,) * 4)
    geo = _tiled(B, K, C, nb or C, wb)
    gs, gm = _tile_model(gpad, seds, morphs, origins, pad, geo)
    rs, rm = kn.grad_gather_plain(gpad, seds, morphs, origins, pad)
    assert np.array_equal(gm, rm.numpy())
    scale = kn.grad_gather_plain(gpad.abs(), seds, morphs, origins, pad)[0]
    assert np.all(np.abs(gs - rs.numpy()) <= 1e-5 * scale.numpy())
    for other in (geo._replace(tile_rows=max(1, geo.tile_rows // 3)),
                  geo._replace(band_group=max(1, C // 2))):
        got = _tile_model(gpad, seds, morphs, origins, pad, other)
        assert np.array_equal(got[0], gs) and np.array_equal(got[1], gm)
    part = _tile_model(gpad[:1], seds[:1], morphs[:1], origins[:1], pad,
                       _tiled(1, K, C, C, wb)._replace(tile_rows=7))
    assert np.array_equal(part[0], gs[:1]) and np.array_equal(part[1],
                                                              gm[:1])


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("H,W", [(58, 48), (57, 47), (5, 12), (3, 200),
                                 (7, 132)])
def test_staging_copy_covers_each_value_once(H, W, shift):
    """The staged route's copy of the whole plane."""
    for vec in ((False, True) if W % 4 == 0 else (False,)):
        if not vec and shift:
            continue               # 4-byte copies run unshifted
        seen, aligned = _stage_cover(3, H, W, shift, vec)
        assert (seen == 1).all()
        assert aligned


@pytest.mark.parametrize("n", [1, 3, 4, 5, 47, 48, 59 * 16, 29000])
def test_bulk_span_fits_its_slot(n):
    """csrc/grad.cu ``bulk_span`` (the tiled route's copy of a gradient
    row or a run of morphology rows): one ``cp.async.bulk`` from the
    source rounded down to 16 bytes, ``4 * quad(shift + n)`` bytes, into a
    slot of ``quad(n + 3)`` floats, the walk reading value x at ``shift +
    x``.  For every offset of the source within 16 bytes: both ends on
    16-byte boundaries, each value copied once to its place, nothing past
    the slot."""
    quad = kn._quads
    for shift in range(4):
        src0 = 4 * 1000 + shift            # the source, in floats
        start, count = src0 - shift, quad(shift + n)
        assert start % 4 == 0 and count % 4 == 0
        assert start <= src0 and src0 + n <= start + count
        assert count <= quad(n + 3)
        dst = np.arange(count) + start     # source index at each place
        assert np.array_equal(dst[shift:shift + n], src0 + np.arange(n))


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
