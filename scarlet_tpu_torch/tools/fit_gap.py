"""Where the box-181 lite fit on the card parts from the CPU's: one engine
iteration stage by stage, the first SED gradients, and whole fits with one
part changed.

The fit is ``testing.large_galaxy_engine`` (the large galaxy, 3 bands,
180 x 180, and a second source, one bucket of box 181), set up on the
card and on the CPU with the card's config (``platform="cuda"``), from the
same host init.  The tool reports, as one JSON line:

- ``stages``: iteration 0 along the CPU's path, each stage of the card's
  iteration run on the CPU's inputs of that stage: its largest difference
  from the CPU's output, relative to the output's largest value (scene,
  model, residual, gradient, K4's g_sed and g_morph, the SED and
  morphology steps, the projection and the epilogue);
- ``g_sed0``: the first iteration's SED gradients, in float64 (the CPU,
  every convolution in float64), on the CPU and on the card, beside
  sum |g * morph|;
- ``fits``: the largest gap of ``--iters`` losses to the CPU's fit,
  relative to its largest loss: the card's fit, the card's with its
  convolutions run on the CPU, the card's with every kernel's plain
  version, the card's and the CPU's with every convolution in float64
  (against each other), and the CPU's with every convolution's result
  times 1 - 2^-24 and 1 + 2^-24 (one float32 rounding of its scale).

Run from a checkout's root, with a CUDA device::

    python -m scarlet_tpu_torch.tools.fit_gap
"""
from __future__ import annotations

import argparse
import json


def _to(x, dev):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_replace"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _rel(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def stages(state, data, config, ctx=None):
    """Bucket 0's intermediates of one packed-branch ``fit_step`` (the
    card's branch at one bucket); with ``ctx`` (another run's
    intermediates) each stage reads its inputs from ``ctx``."""
    import torch

    from ..lite import engine
    from ..ops import kernels as kn
    from ..optim import adaprox_step

    dev = data.images.device
    r = {}

    def inp(name):
        return _to(ctx[name], dev) if ctx is not None else r[name]

    hyper = dict(scheme=config.scheme, b1=config.b1, b2=config.b2,
                 eps=config.eps, p=config.p,
                 max_prox_iter=config.max_prox_iter)
    seds, morphs = state.seds[0], state.morphs[0]
    gate = state.active[..., None] & state.comp_active[0]
    r["scene"] = engine.make_scene(state, config)
    r["model"] = engine._convolve(inp("scene"), data.kernel_rfft, config)
    r["residual"] = data.weights * (inp("model") - data.images)
    r["gradient"] = engine._convolve(inp("residual"), data.grad_kernel_rfft,
                                     config)
    r["g_sed"], r["g_morph"] = kn.grad_gather(inp("gradient"), seds, morphs,
                                              state.origins[0], 0)
    step = torch.maximum(data.sed_step_min[..., None, :],
                         config.sed_step_factor
                         * seds.sum(dim=-1, keepdim=True)
                         / config.scene_shape[0])
    r["sed_step"] = adaprox_step(
        seds, inp("g_sed"), state.it[..., None, None], state.sed_opt[0],
        step, prox=lambda x, s: torch.clamp_min(x, config.floor),
        active=gate[..., None], param_dims=(-1,), **hyper)[0]
    r["morph_step"] = adaprox_step(
        morphs, inp("g_morph"), state.it[..., None, None, None],
        state.morph_opt[0], config.morph_step, prox=None, **hyper)[0] \
        * data.box_masks[0]
    idx = kn.candidate_index(inp("morph_step"), config.fit_center_radius)
    r["projection"] = kn.monotonic_prox(
        inp("morph_step"), idx, data.mono_weights[0], data.mono_keep[0],
        config.mono_n_iters[0], config.min_gradient,
        tol=engine._projection_tol(config, state.it))
    r["epilogue"] = kn.chain_epilogue(
        inp("projection").clone(),
        engine._cutoff(inp("sed_step"), data, config), gate, morphs,
        config.floor)
    return r


def g_sed0(state, data, config, exact=False):
    """The first SED gradients (float64 sums of float32 or float64
    gradients) and sum |g * morph|."""
    from ..lite import engine
    from ..ops import kernels as kn
    from ..testing import convolution_probe

    with convolution_probe(exact=exact):
        model = engine._convolve(engine.make_scene(state, config),
                                 data.kernel_rfft, config)
        grad = engine._convolve(data.weights * (model - data.images),
                                data.grad_kernel_rfft, config)
    args = [t.cpu().double() for t in (state.seds[0], state.morphs[0])]
    g = kn.grad_gather_plain(grad.cpu().double(), *args,
                             state.origins[0].cpu(), 0)[0]
    a = kn.grad_gather_plain(grad.cpu().double().abs(), *map(abs, args),
                             state.origins[0].cpu(), 0)[0]
    return g.tolist(), a.tolist()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..lite import engine
    from ..ops import kernels as kn
    from ..testing import convolution_probe, large_galaxy_engine
    from ..testing.galaxy import UNIT_ROUNDOFF

    dev = torch.device(args.device)

    def setup(where):
        return large_galaxy_engine(where, platform="cuda")

    def fit(where, **probe):
        config, data, state = setup(where)
        with convolution_probe(**probe):
            return engine.fit_scan(state, data, config, args.iters)[1] \
                .cpu().double().numpy()

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    cfg_d, data_d, st_d = setup(dev)
    cfg_h, data_h, st_h = setup("cpu")
    out = dict(config_equal=cfg_d == cfg_h, packed=engine.packed_morphs_ok(
        cfg_d), card=torch.cuda.get_device_name(0) if dev.type == "cuda"
        else "cpu")
    ctx = stages(st_h, data_h, cfg_h)
    card = stages(_to(st_h, dev), data_d, cfg_d, ctx)
    out["stages"] = {k: _rel(card[k], ctx[k]) for k in ctx}
    out["g_sed0"] = dict(float64=g_sed0(st_h, data_h, cfg_h, exact=True),
                         cpu=g_sed0(st_h, data_h, cfg_h),
                         card=g_sed0(st_d, data_d, cfg_d))

    cpu = fit("cpu")
    fits = dict(card=gap(fit(dev), cpu),
                card_convolving_on_the_cpu=gap(fit(dev, device="cpu"), cpu))
    names = ("monotonic_prox", "scene_assembly", "grad_gather")
    kept = [getattr(kn, n) for n in names]
    for n in names:
        setattr(kn, n, getattr(kn, n + "_plain"))
    try:
        fits["card_every_kernel_plain"] = gap(fit(dev), cpu)
    finally:
        for n, f in zip(names, kept):
            setattr(kn, n, f)
    fits["float64_convolutions"] = gap(fit(dev, exact=True),
                                       fit("cpu", exact=True))
    for s in (-1, 1):
        fits[f"cpu_scaled_{s:+d}u"] = gap(
            fit("cpu", scale=s * UNIT_ROUNDOFF), cpu)
    out["fits"] = fits
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
