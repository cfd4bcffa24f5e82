"""The padded training step on the capacity layout against the JAX package,
on the CPU.

Without a flat budget (every step before ``FLAT_AFTER``, and every step of
a multi-cascade scene) ``render_train`` evaluates the field on a static
buffer of N * S slots (``models/rendering.py::_eval_capacity`` with
``by_entry``), the JAX padded branch's shape, so that the fused runner can
capture the step:

* against the JAX ``render_train``'s padded branch: rgb, opacity, depth,
  the loss and every parameter gradient, fed the same march jitter, the
  same random background and the same (N * S, m) sampled-corner uniforms
  (the sample at entry e takes row e); LowRank and MixedFeature, at one
  cascade and at five (``--scale 8``, the cascade march), with a random
  background and with an exposure column (the HDR head). Tolerances
  (tests/test_torch_fused.py's): the frames atol 1e-5, the loss rtol
  1e-5, the gradients rtol 1e-4 with atol 1e-5 of the largest value. The
  loss and gradients are those of the rays whose every hidden ReLU gate is
  decided by more than RELU_MARGIN of its scale (tests/
  test_torch_train.py's rule, over 90% of the rays), the others' loss
  terms weighted 0 on both sides: nearer 0 the packages' sums in other
  orders can flip a gate, and the gradients then part by that unit's whole
  contribution.
* against the port's own nonzero path (``_eval_valid``, the valid rows of
  the same draw) on the same batch: rtol and atol 1e-6 of the largest
  value.
* the trainer: the fused runner's control flow from step 0 across
  ``FLAT_AFTER`` on a single-cascade scene (the padded graph, then the
  flat one) with CUDA graphs replaced by tests/test_torch_fused.py's
  stand-in, bit for bit the eager trainer; and the unit-exposure target
  made once on the device.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfnerf_tpu import losses as jlosses
from mfnerf_tpu.models import ngp as jngp
from mfnerf_tpu.models import rendering as jrendering
from mfnerf_tpu.ops import ray_march as jmarch

from mfnerf_tpu_torch import losses as tlosses
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy

from test_torch_fused import (FRAME_ATOL, GRAD_REL_ATOL, GRAD_RTOL,
                              LOSS_RTOL, SELF_RTOL, _fused_system, _nonzero,
                              _stand_in_runner)
from test_torch_train import (HASH, SMALL, _batch, _clear_relu_mask,
                              _close, _one_torch_thread, _t)

assert _one_torch_thread       # the autouse fixture, for this module too

N_RAYS = 256
S_MAX = 32
M = 4                          # sampled corners of the hash grids' gradient
EXPOSURES = np.float32([0.5, 1.0, 2.0, 0.25])
# (grid, scale, flags): one cascade (synthetic, white background) and five
# (--scale 8, the cascade march, black or random background)
CASES = [("LowRank", 0.5, ""), ("MixedFeature", 0.5, ""),
         ("LowRank", 0.5, "exposure"), ("MixedFeature", 0.5, "exposure"),
         ("LowRank", 8.0, ""), ("MixedFeature", 8.0, ""),
         ("LowRank", 8.0, "random_bg"), ("MixedFeature", 8.0, "random_bg"),
         ("LowRank", 8.0, "exposure"),
         ("MixedFeature", 8.0, "exposure-random_bg")]
IDS = ["-".join(filter(None, (g, "5c" if s > 1 else "1c", f)))
       for g, s, f in CASES]


def _models(grid, scale, hdr):
    cfg = dict(SMALL, grid=grid, scale=scale,
               rgb_act="None" if hdr else "Sigmoid")
    if grid != "LowRank":
        cfg.update(HASH, N_tables=2, hash_grad_samples=M)
    jmodel = jngp.NGP(jngp.NGPConfig(max_samples=256, **cfg))
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = tngp.NGP(tngp.NGPConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


def _padded_batch(scale, hdr, seed):
    """_batch's rays at ``scale`` (the origin moved out with the box), its
    occupancy for the scale's cascades, and with ``hdr`` each ray's
    exposure."""
    cascades = tngp.NGPConfig(scale=scale, **SMALL).cascades
    bits, rays_o, rays_d, _, target = _batch(n=N_RAYS, seed=seed,
                                             fill=0x33, cascades=cascades)
    rays_o = rays_o * np.float32(2 * scale)
    exposure = None
    if hdr:
        exposure = np.random.default_rng(seed).choice(
            EXPOSURES, N_RAYS)[:, None].astype(np.float32)
    return bits, rays_o, rays_d, target, exposure


def _kept(term, keep):
    """A per-ray loss term (N,) or (N, 3), 0 on the rays not ``keep``."""
    return term * (keep[:, None] if term.ndim == 2 else keep)


def _rcfg_kw(scale, flags):
    e = 1 / 256 if scale > 0.5 else 0.0
    return dict(s_max_train=S_MAX, max_samples=256, exp_step_factor=e,
                s_strata=8, random_bg="random_bg" in flags)


@pytest.mark.parametrize("grid,scale,flags", CASES, ids=IDS)
def test_padded_capacity_matches_jax_padded_render_train(grid, scale,
                                                         flags):
    """render_train without ``s_flat`` (the capacity buffer of N * S
    slots) against the JAX render_train's padded branch, its loss and
    every parameter gradient. The JAX side runs under jit for LowRank (the
    unfused fp32 encoder) and op by op for the hash grid (XLA may contract
    its x * scale + 0.5)."""
    hdr = "exposure" in flags
    jmodel, params, tmodel = _models(grid, scale, hdr)
    bits, rays_o, rays_d, target, exposure = _padded_batch(scale, hdr, 2)
    rcfg_kw = _rcfg_kw(scale, flags)
    if scale > 1:
        assert jmarch.cascades_stratum(rcfg_kw["exp_step_factor"], scale,
                                       tmodel.cfg.cascades)[0] > 0
    key = jax.random.PRNGKey(3)
    k_noise, k_bg, k_gn = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (N_RAYS,)))
    bg = np.asarray(jax.random.uniform(k_bg, (3,)))
    grad_noise = None
    if grid != "LowRank":
        grad_noise = np.asarray(jax.random.uniform(k_gn, (N_RAYS * S_MAX,
                                                          M)))
    occ_j = dataclasses.replace(
        jngp.OccupancyState.create(jmodel.cfg),
        density_bitfield=jnp.asarray(bits)).refresh_coarse(jmodel.cfg)
    rcfg_j = jrendering.RenderConfig(**rcfg_kw)
    loss_j_mod = jlosses.NeRFLoss()

    def loss_j(p):
        res = jrendering.render_train(
            jmodel, p, occ_j, jnp.asarray(rays_o), jnp.asarray(rays_d), key,
            rcfg_j, exposure=None if exposure is None
            else jnp.asarray(exposure))
        terms = loss_j_mod(res, {"rgb": jnp.asarray(target)})
        return sum((_kept(v, jnp.asarray(keep))).mean()
                   for v in terms.values()), res

    occ_t = dataclasses.replace(tngp.OccupancyState.create(tmodel.cfg, "cpu"),
                                density_bitfield=_t(bits)
                                ).refresh_coarse(tmodel.cfg)

    def render_t():
        return trendering.render_train(
            tmodel, occ_t, _t(rays_o), _t(rays_d), _t(noise),
            trendering.RenderConfig(**rcfg_kw), bg_rgb=_t(bg),
            grad_noise=None if grad_noise is None else _t(grad_noise),
            exposure=None if exposure is None else _t(exposure))

    keep = _clear_relu_mask(render_t)
    assert keep.mean() > 0.9, keep.mean()
    step = jax.value_and_grad(loss_j, has_aux=True)
    if grid == "LowRank":
        (lj, want), grads_j = jax.jit(step)(params)
    else:
        with jax.disable_jit():
            (lj, want), grads_j = step(params)

    got = render_t()
    lt = sum(_kept(v, _t(keep)).mean() for v in tlosses.NeRFLoss()(
        got, {"rgb": _t(target)}).values())
    lt.backward()

    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    assert int(got["mask"].sum()) > 1000
    assert int(got["rm_samples"]) == int(want["rm_samples"])
    for key_ in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   np.asarray(want[key_]), atol=FRAME_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj),
                               rtol=LOSS_RTOL)
    want_g = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(want_g) == {k for k, _ in tmodel.named_parameters()}
    if hdr:
        assert "tonemappers.2.1" in want_g
    for name, p in tmodel.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        assert np.abs(g).max() > 0, name
        _close(g, w, rtol=GRAD_RTOL, rel_atol=GRAD_REL_ATOL)


@pytest.mark.parametrize("grid,scale,flags", [
    ("LowRank", 0.5, ""), ("MixedFeature", 0.5, "exposure"),
    ("LowRank", 8.0, "exposure"), ("MixedFeature", 8.0, "random_bg")],
    ids=["LowRank-1c", "MixedFeature-1c-exposure", "LowRank-5c-exposure",
         "MixedFeature-5c-random_bg"])
def test_padded_capacity_matches_nonzero_path(grid, scale, flags,
                                              monkeypatch):
    """The padded capacity buffer against ``_eval_valid`` on the same
    batch, handed the valid samples' rows of the same (N * S, m) draw: the
    fused LowRank encoder (hat_prod with the count) and the hash grid with
    sampled corners; outputs and every gradient."""
    hdr = "exposure" in flags
    cfg = dict(SMALL, grid=grid, scale=scale, lr_fused=True,
               rgb_act="None" if hdr else "Sigmoid")
    if grid != "LowRank":
        cfg.update(HASH, N_tables=2, hash_grad_samples=M)
    model = tngp.NGP(tngp.NGPConfig(**cfg), torch.Generator().manual_seed(5),
                     device="cpu")
    bits, rays_o, rays_d, target, exposure = _padded_batch(scale, hdr, 4)
    noise = np.random.default_rng(6).random(N_RAYS, dtype=np.float32)
    occ = dataclasses.replace(tngp.OccupancyState.create(model.cfg, "cpu"),
                              density_bitfield=_t(bits)
                              ).refresh_coarse(model.cfg)
    rcfg = trendering.RenderConfig(**_rcfg_kw(scale, flags))
    grad_noise = None
    if grid != "LowRank":
        grad_noise = torch.from_numpy(np.random.default_rng(7).random(
            (N_RAYS * S_MAX, M), dtype=np.float32))
    bg = torch.tensor([0.2, 0.5, 0.9])
    runs = {}
    for label in ("capacity", "nonzero"):
        with contextlib.ExitStack() as stack:
            if label == "nonzero":
                stack.enter_context(monkeypatch.context()).setattr(
                    trendering, "_eval_capacity", _nonzero)
            model.zero_grad(set_to_none=True)
            res = trendering.render_train(
                model, occ, _t(rays_o), _t(rays_d), _t(noise), rcfg, bg,
                grad_noise=grad_noise,
                exposure=None if exposure is None else _t(exposure))
            loss = sum(v.mean() for v in tlosses.NeRFLoss()(
                res, {"rgb": _t(target)}).values())
            loss.backward()
        runs[label] = (res, float(loss.detach()),
                       {k: p.grad.clone() for k, p in
                        model.named_parameters()})
    (res_c, loss_c, g_c), (res_n, loss_n, g_n) = runs["capacity"], \
        runs["nonzero"]
    assert torch.equal(res_c["mask"], res_n["mask"])
    assert int(res_c["mask"].sum()) > 1000
    for key in ("rgb", "opacity", "depth", "ws"):
        _close(res_c[key].detach(), res_n[key].detach(), rtol=SELF_RTOL,
               rel_atol=SELF_RTOL)
    np.testing.assert_allclose(loss_c, loss_n, rtol=SELF_RTOL)
    for name in g_n:
        assert g_n[name].abs().max() > 0, name
        _close(g_c[name], g_n[name], rtol=SELF_RTOL, rel_atol=SELF_RTOL)


def test_fused_runner_from_step_zero_matches_eager(monkeypatch):
    """The fused runner from step 0 across FLAT_AFTER on a single-cascade
    LowRank scene, its graphs replaced by the stand-in: the padded step's
    warm-up, capture and replays from step 0, then at FLAT_AFTER the
    padded graph dropped and the flat step's own warm-up, capture and
    replays; the same metrics, parameters, Adam state and bitfield bit for
    bit as the eager trainer over the same steps. (The hash grids' padded
    draw is held across the runner by test_torch_fused.py's control-flow
    test, whose MixedFeature history also starts at step 0.)"""
    kw = dict(batch_size=64, steps_per_epoch=2 * ttrain.FLAT_AFTER)
    eager = _fused_system(**kw)
    chunks = (5, ttrain.FLAT_AFTER - 7, 10)        # 0-5, 5-510, 510-520
    want = [eager.fit(n) for n in chunks]

    system = _fused_system(**kw)
    runner, kinds = _stand_in_runner(system, monkeypatch)
    got = [system.fit(n) for n in chunks]
    assert system.fused is runner
    assert kinds == ["padded", "flat"]
    assert runner.kind == "flat" and runner.warm == ttrain.FUSED_WARMUP
    assert runner.step_graph is not None
    assert set(runner.launches) == {runner.step_graph,
                                    *runner.refresh_graphs.values()}
    for w, g in zip(want, got):
        for key in w:
            assert torch.equal(w[key], g[key]), key
    for (name, a), b in zip(eager.model.state_dict().items(),
                            system.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(eager.model.parameters(), system.model.parameters()):
        for key, v in eager.optimizer.state[p].items():
            assert torch.equal(v, system.optimizer.state[q][key]), key
    assert torch.equal(eager.occ.density_bitfield,
                       system.occ.density_bitfield)


def test_unit_exposure_target_on_the_device():
    """--use_exposure: the dataset's unit-exposure rgb is staged once, at
    configure, as a float32 tensor on the trainer's device, and the
    unit-exposure term is the JAX package's half squared error of the
    bias-free tonemappers' rgb (sigmoid(0) = 0.5) against it."""
    system = _fused_system(scale=8.0, use_exposure=True, exposures=True)
    target = system.unit_exposure_rgb
    assert torch.is_tensor(target) and target.dtype == torch.float32
    assert target.device == system.device
    assert float(target) == float(np.float32(0.73))
    terms = system.losses({"rgb": torch.zeros((4, 3)),
                           "opacity": torch.full((4,), 0.5)},
                          {"rgb": torch.zeros((4, 3))})
    want = np.float32(0.5) * (np.float32(0.5) - np.float32(0.73)) ** 2
    np.testing.assert_array_equal(terms["unit_exposure"].detach().numpy(),
                                  np.full((1, 3), want, np.float32))
