"""The port's display modules (``display``, ``lite.display`` and the
``draw_*`` helpers of ``detect``) against the JAX package's on the CPU.

Numerics bit for bit: ``channels_to_rgb``, both mappings, both
percentile norms, ``img_to_3channel`` and ``img_to_rgb`` (with a mask),
on seeded numpy inputs, and on the same values as tensors.  Figures: each
figure function's panel count, titles, axis labels, text labels, patch
geometry, lines and ``AxesImage`` arrays against the JAX package's
figure of the same models.  Object-tree models: the JAX package's
``init_all_sources`` on float64 frames with ``set_spectra=False``, carried
across by ``convert.sources_from_jax``; the likelihood plots of one
history (the port's two-iteration fit from a copy of that start).  Lite
models: each package's own init (the same decisions and boxes), the
port's values then set to the JAX package's, weighted for the
``use_flux`` panels.  A panel that renders a model (rendered, residual)
may differ by one level in 255: the port renders the figure's model in
float64 on the observation's device, the JAX lite display in float32, and
the two packages' FFTs round differently; so may the PSF panel, whose
image each package normalizes summing in its own order (~2e-17 apart in
float64).  Every other panel is equal.
The renders' norms have a minimum of 0: below a negative minimum both
mappings divide by the intensity, so a pixel of roundoff (~1e-17) takes
an arbitrary colour in either package.
"""
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from numpy.testing import assert_allclose, assert_array_equal  # noqa: E402

import scarlet_tpu as jst  # noqa: E402
from scarlet_tpu import display as jdisp  # noqa: E402
from scarlet_tpu import lite as jlite  # noqa: E402
from scarlet_tpu.lite import display as jldisp  # noqa: E402
import scarlet_tpu_torch as tst  # noqa: E402
from scarlet_tpu_torch import convert  # noqa: E402
from scarlet_tpu_torch import display as tdisp  # noqa: E402
from scarlet_tpu_torch import lite as tlite  # noqa: E402
from scarlet_tpu_torch import models as tm  # noqa: E402
from scarlet_tpu_torch.lite import display as tldisp  # noqa: E402
from scarlet_tpu_torch.testing import generate_blend  # noqa: E402

SHAPE = (3, 32, 32)
RENDERED = ("Rendered", "Residual", "PSF")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cube(seed, shape=(5, 12, 11)):
    return np.random.default_rng(seed).normal(1.0, 2.0, shape)


# --------------------------------------------------------------------------
# numerics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("channels", range(1, 8))
def test_channels_to_rgb_bitwise(channels):
    t = tdisp.channels_to_rgb(channels)
    assert_array_equal(t, jdisp.channels_to_rgb(channels))
    t[0, 0] = 99.0
    assert tdisp.channels_to_rgb(channels)[0, 0] != 99.0
    with pytest.raises(AssertionError):
        tdisp.channels_to_rgb(8)


@pytest.mark.parametrize("as_tensor", (False, True))
def test_mappings_and_norms_bitwise(as_tensor):
    img = _cube(0)
    planes = jdisp.img_to_3channel(img)

    def arg(x):
        return torch.from_numpy(x) if as_tensor else x

    for name, kw in (("LinearMapping", dict(minimum=0.5, maximum=3.0)),
                     ("LinearMapping", dict(image=planes)),
                     ("AsinhMapping", dict(minimum=0, stretch=0.1, Q=10))):
        tkw = {k: arg(v) if k == "image" else v for k, v in kw.items()}
        j, t = getattr(jdisp, name)(**kw), getattr(tdisp, name)(**tkw)
        got = t.make_rgb_image(*map(arg, planes))
        assert got.dtype == np.uint8
        assert_array_equal(got, j.make_rgb_image(*planes))
    for name in ("LinearPercentileNorm", "AsinhPercentileNorm"):
        j, t = getattr(jdisp, name)(img), getattr(tdisp, name)(arg(img))
        assert type(t).__name__ == type(j).__name__
        assert t.__dict__ == j.__dict__
        assert_array_equal(t.make_rgb_image(*map(arg, planes)),
                           j.make_rgb_image(*planes))


@pytest.mark.parametrize("as_tensor", (False, True))
def test_img_to_rgb_bitwise(as_tensor):
    img = _cube(1).astype(np.float32)
    mask = np.zeros(img.shape[1:], bool)
    mask[:3, 2:7] = True
    cmap = np.random.default_rng(2).random((3, 5))
    arg = torch.from_numpy(img) if as_tensor else img
    marg = torch.from_numpy(mask) if as_tensor else mask
    assert_array_equal(tdisp.img_to_3channel(arg),
                       jdisp.img_to_3channel(img))
    assert_array_equal(tdisp.img_to_3channel(arg, channel_map=cmap),
                       jdisp.img_to_3channel(img, channel_map=cmap))
    assert_array_equal(tdisp.img_to_3channel(arg[0]),
                       jdisp.img_to_3channel(img[0]))
    for kw in ({}, {"channel_map": cmap},
               {"norm": jdisp.AsinhPercentileNorm(img)}):
        tkw = dict(kw)
        if "norm" in kw:
            tkw["norm"] = tdisp.AsinhPercentileNorm(arg)
        assert_array_equal(tdisp.img_to_rgb(arg, **tkw),
                           jdisp.img_to_rgb(img, **kw))
        got = tdisp.img_to_rgb(arg, mask=marg, **tkw)
        assert got.shape == img.shape[1:] + (4,)
        assert_array_equal(got, jdisp.img_to_rgb(img, mask=mask, **kw))
    assert tdisp.get_extent(tst.Box((3, 5, 7), (0, 2, 1))) == \
        jdisp.get_extent(jst.Box((3, 5, 7), (0, 2, 1)))
    assert tdisp.panel_size == jdisp.panel_size


# --------------------------------------------------------------------------
# figures
# --------------------------------------------------------------------------
def _figure(fig):
    """What a figure shows: per axis its title, labels, texts, patches,
    lines and images."""
    out = []
    for ax in fig.axes:
        patches = []
        for p in ax.patches:
            xy = np.asarray(p.get_xy(), float) if hasattr(p, "get_xy") \
                else None
            patches.append((type(p).__name__, xy,
                            getattr(p, "get_width", lambda: None)(),
                            getattr(p, "get_height", lambda: None)(),
                            p.get_edgecolor()))
        out.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(),
            ylabel=ax.get_ylabel(),
            xticklabels=[t.get_text() for t in ax.get_xticklabels()],
            texts=[(t.get_text(), np.asarray(t.get_position(), float),
                    t.get_color()) for t in ax.texts],
            patches=patches,
            lines=[(np.asarray(ln.get_xydata(), float), ln.get_label(),
                    ln.get_marker()) for ln in ax.lines],
            images=[(np.asarray(im.get_array()), im.get_extent())
                    for im in ax.get_images()]))
    plt.close(fig)
    return out


def _assert_same_figure(tfig, jfig, atol_xy=1e-9):
    t, j = _figure(tfig), _figure(jfig)
    assert len(t) == len(j)
    for ta, ja in zip(t, j):
        for key in ("title", "xlabel", "ylabel", "xticklabels"):
            assert ta[key] == ja[key], key
        assert [x[0] for x in ta["texts"]] == [x[0] for x in ja["texts"]]
        for (_, tp, tc), (_, jp, jc) in zip(ta["texts"], ja["texts"]):
            assert_allclose(tp, jp, atol=atol_xy)
            assert tc == jc
        assert len(ta["patches"]) == len(ja["patches"])
        for tp, jp in zip(ta["patches"], ja["patches"]):
            assert tp[0] == jp[0] and tp[4] == jp[4]
            assert_allclose(tp[1], jp[1], atol=atol_xy)
            assert tp[2] == pytest.approx(jp[2]) and \
                tp[3] == pytest.approx(jp[3])
        assert len(ta["lines"]) == len(ja["lines"])
        for (txy, tl, tmk), (jxy, jl, jmk) in zip(ta["lines"], ja["lines"]):
            assert tl == jl and tmk == jmk
            assert_allclose(txy, jxy, rtol=1e-6, atol=atol_xy)
        assert len(ta["images"]) == len(ja["images"])
        for (tim, text), (jim, jext) in zip(ta["images"], ja["images"]):
            assert tim.shape == jim.shape and tim.dtype == jim.dtype
            assert_allclose(text, jext)
            if any(word in ta["title"] for word in RENDERED):
                diff = np.abs(tim.astype(int) - jim.astype(int))
                assert diff.max() <= 1, ta["title"]
            else:
                assert_array_equal(tim, jim, err_msg=ta["title"])


@pytest.fixture(scope="module")
def tree():
    """Both packages' object-tree scene: float64 frames, a masked corner,
    the JAX init without the spectrum solve carried across; the port's
    loss history of a two-iteration fit from a copy in both blends."""
    d = generate_blend(np.random.default_rng(4), shape=SHAPE, n_sources=3)
    ch = list(d["filters"])
    images = d["images"]
    weights = (1 / d["variance"]).astype(np.float32)
    weights[:, :4, :6] = 0
    psfs = d["psfs"].astype(np.float64)
    jframe = jst.Frame(images.shape, channels=ch, dtype=np.float64,
                       psf=jst.GaussianPSF(sigma=0.8, boxsize=15))
    jobs = jst.Observation(images, psf=jst.ImagePSF(psfs), weights=weights,
                           channels=ch).match(jframe)
    tframe = tm.Frame(images.shape, channels=ch, dtype=np.float64,
                      psf=tm.GaussianPSF(sigma=0.8, boxsize=15))
    tobs = tm.Observation(images, ch, psf=tm.ImagePSF(psfs),
                          weights=weights, device="cpu").match(tframe)
    centers = [(float(r["y"]), float(r["x"])) for r in d["catalog"]]
    jsrc, _ = jst.initialization.init_all_sources(
        jframe, centers, jobs, max_components=2, min_snr=10, silent=True,
        set_spectra=False)
    tsrc = convert.sources_from_jax(jsrc, tframe, device="cpu")
    # the port's likelihood history of a two-iteration fit, in both blends
    tb = tm.Blend(convert.sources_from_jax(jsrc, tframe, device="cpu"), tobs)
    tb.fit(2, e_rel=0)
    jb = jst.Blend(jsrc, jobs)
    jb.loss = list(tb.loss)
    return dict(jsrc=jsrc, jobs=jobs, jb=jb, tsrc=tsrc, tobs=tobs, tb=tb,
                centers=centers, images=images)


def test_tree_scene_has_a_multi_component_source(tree):
    assert any(len(s.children) > 1 and isinstance(s.children[0],
                                                   tm.Component)
               for s in tree["tsrc"])


@pytest.mark.parametrize("kw", (
    dict(show_observed=True, show_rendered=True, show_residual=True,
         add_boxes=True),
    dict(add_labels=False),
    dict(show_rendered=True, show_residual=True, linear=False,
         norm=(0.1, 10)),
))
def test_show_scene_matches_jax(tree, kw):
    jkw, tkw = dict(kw), dict(kw)
    if "norm" in kw:
        jkw["norm"] = jdisp.AsinhMapping(0, *kw["norm"])
        tkw["norm"] = tdisp.AsinhMapping(0, *kw["norm"])
    with_obs = any(k.startswith("show_") for k in kw)
    _assert_same_figure(
        tdisp.show_scene(tree["tsrc"], tree["tobs"] if with_obs else None,
                         **tkw),
        jdisp.show_scene(tree["jsrc"], tree["jobs"] if with_obs else None,
                         **jkw))


def test_show_sources_matches_jax(tree):
    kw = dict(show_rendered=True, show_observed=True, add_boxes=True)
    _assert_same_figure(
        tdisp.show_sources(tree["tsrc"], tree["tobs"], **kw),
        jdisp.show_sources(tree["jsrc"], tree["jobs"], **kw))
    # one multi-component source: its components, one per row
    k = next(i for i, s in enumerate(tree["tsrc"]) if len(s.children) > 1
             and isinstance(s.children[0], tm.Component))
    _assert_same_figure(
        tdisp.show_sources(tree["tsrc"][k], tree["tobs"], **kw),
        jdisp.show_sources(tree["jsrc"][k], tree["jobs"], **kw))


def test_show_observation_and_likelihood_match_jax(tree):
    norm = dict(norm=jdisp.AsinhMapping(minimum=0, stretch=0.1, Q=10))
    _assert_same_figure(
        tdisp.show_observation(tree["tobs"], sky_coords=tree["centers"],
                               show_psf=True, **norm),
        jdisp.show_observation(tree["jobs"], sky_coords=tree["centers"],
                               show_psf=True, **norm))
    jfig = jdisp.show_likelihood(tree["jb"])
    tfig = tdisp.show_likelihood(tree["tb"])
    assert len(tfig.axes[0].lines[0].get_ydata()) == 2
    _assert_same_figure(tfig, jfig)


def test_panel_functions_are_what_the_figures_draw(tree):
    """``scene_panels``, ``source_panels`` and ``observation_panels`` (the
    display's numpy half, which needs no matplotlib) give the titles and
    RGB arrays that the figures show."""
    tsrc, tobs = tree["tsrc"], tree["tobs"]
    kw = dict(show_observed=True, show_rendered=True, show_residual=True)
    norm = tdisp.AsinhMapping(0, 0.1, 10)
    cases = (
        (tdisp.show_scene(tsrc, tobs, **kw),
         tdisp.scene_panels(tsrc, tobs, **kw)),
        (tdisp.show_sources(tsrc, tobs, norm=norm, show_rendered=True,
                            show_observed=True),
         [p for _, row, _ in tdisp.source_panels(
             tsrc, tobs, norm=norm, show_rendered=True, show_observed=True)
          for p in row]),
        (tdisp.show_observation(tobs, norm=norm, sky_coords=tree["centers"],
                                show_psf=True),
         tdisp.observation_panels(tobs, norm=norm, show_psf=True)))
    for fig, panels in cases:
        drawn = [(ax.get_title(), np.asarray(im.get_array()))
                 for ax in fig.axes for im in ax.get_images()]
        plt.close(fig)
        assert [t for t, _ in drawn] == [t for t, _, _ in panels]
        for (_, a), (_, b, _) in zip(drawn, panels):
            assert_array_equal(a, b)


@pytest.fixture(scope="module")
def lite_blends():
    """Each package's lite blend of one generated scene: the same init
    decisions and boxes (held here), the port's SEDs, morphologies and
    weighted fluxes then set to the JAX package's values (the two inits
    agree to ~1e-5, tests/test_torch_lite.py), so both draw one model."""
    d = generate_blend(np.random.default_rng(5), shape=SHAPE, n_sources=3)
    nrms = np.sqrt(d["variance"].astype(np.float64)).mean(
        axis=(1, 2)).astype(np.float32)
    weights = (1 / d["variance"]).astype(np.float32)
    centers = [(int(np.round(r["y"])), int(np.round(r["x"])))
               for r in d["catalog"]]
    out = []
    for lite in (jlite, tlite):
        obs = lite.LiteObservation(
            d["images"], d["variance"], weights, d["psfs"], noise_rms=nrms,
            model_psf=lite.integrated_circular_gaussian(sigma=0.8)[None]
            .astype(np.float32),
            **({"device": "cpu"} if lite is tlite else {}))
        src = lite.parameterize_sources(
            lite.init_all_sources_main(obs, centers, min_snr=50), obs,
            lite.init_adaprox_component)
        blend = lite.LiteBlend(src, obs)
        lite.weight_sources(blend)
        out.append(blend)
    jb, tb = out
    for js, ts in zip(jb.sources, tb.sources):
        assert len(js.components) == len(ts.components)
        for jc, tc in zip(js.components, ts.components):
            assert jc.bbox == tc.bbox
            tc._sed.x = torch.from_numpy(np.array(jc.sed))
            tc._morph.x = torch.from_numpy(np.array(jc.morph))
        if js.flux is not None:
            assert js.flux_box == ts.flux_box
            ts.flux = np.array(js.flux)
    return out


def test_lite_models_bitwise(lite_blends):
    jb, tb = lite_blends
    assert_array_equal(tb.get_model(), np.asarray(jb.get_model()))
    assert_array_equal(tb.get_model(use_flux=True),
                       np.asarray(jb.get_model(use_flux=True)))


@pytest.mark.parametrize("kw", (
    dict(show_observed=True, show_rendered=True, show_residual=True,
         add_boxes=True),
    dict(show_rendered=True, show_residual=True, use_flux=True,
         linear=False),
))
def test_lite_show_scene_matches_jax(lite_blends, kw):
    jb, tb = lite_blends
    _assert_same_figure(tldisp.show_scene(tb, **kw),
                        jldisp.show_scene(jb, **kw))


@pytest.mark.parametrize("use_flux", (False, True))
def test_lite_show_sources_matches_jax(lite_blends, use_flux):
    jb, tb = lite_blends
    kw = dict(show_rendered=True, show_observed=True, add_boxes=True,
              use_flux=use_flux)
    _assert_same_figure(
        tldisp.show_sources(tb, norm=tdisp.AsinhMapping(0, 0.1, 10), **kw),
        jldisp.show_sources(jb, norm=jdisp.AsinhMapping(0, 0.1, 10), **kw))


def test_compare_spectra_matches_jax(lite_blends):
    jb, tb = lite_blends
    jfig = jldisp.compare_spectra(first=jb.sources, second=jb.sources[::-1])
    tfig = tldisp.compare_spectra(first=tb.sources, second=tb.sources[::-1])
    assert [t.get_text() for t in tfig.legends[0].get_texts()] == \
        [t.get_text() for t in jfig.legends[0].get_texts()]
    _assert_same_figure(tfig, jfig)
    with pytest.raises(ValueError, match="same number"):
        tldisp.compare_spectra(a=tb.sources, b=tb.sources[:1])


def test_lite_display_reexports():
    for name in ("panel_size", "channels_to_rgb", "LinearPercentileNorm",
                 "AsinhPercentileNorm", "img_to_3channel", "img_to_rgb",
                 "get_extent"):
        assert getattr(tldisp, name) is getattr(tdisp, name)
    assert tldisp.__all__ == jldisp.__all__
    assert tdisp.__all__ == jdisp.__all__


def test_draw_helpers_match_jax():
    from scarlet_tpu import detect as jdet
    from scarlet_tpu_torch import detect as tdet

    d = generate_blend(np.random.default_rng(6), shape=(3, 40, 40),
                       n_sources=4)
    detect = tdet.get_detect_wavelets(d["images"], d["variance"])
    figs = []
    for det in (tdet, jdet):
        structures, tree = det.get_blend_structures(detect)
        fig, ax = plt.subplots()
        det.draw_region(tree, ax)
        for s in structures:
            det.draw_footprint_box(s.footprint, ax)
        det.draw_box(det.bounds_to_bbox((2, 9, 3, 11)), ax, "b")
        figs.append(fig)
    assert len(figs[0].axes[0].patches) > 3
    _assert_same_figure(*figs)
