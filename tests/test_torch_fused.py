"""The fused training runner's parts against the JAX package, on the CPU.

* The capacity layout (``models/rendering.py::_eval_capacity``, which
  ``render_train`` takes with ``s_flat``) against the JAX ``render_train``'s
  flat branch: rgb, opacity, depth, the loss and every parameter gradient,
  fed the same march jitter and the same (N * s_flat, m) sampled-corner
  uniforms; with the cut binding (every slot valid), under the budget, with
  no valid sample, and with every (N, S) slot valid. Tolerances: the frames
  atol 1e-5 (``test_render_train_matches_jax_render_train``'s), the loss
  rtol 1e-5 and the gradients rtol 1e-4 with atol 1e-5 of the largest value
  (``test_train_step_matches_jax``'s: sums over thousands of samples in
  another order).
* The capacity layout against the port's own nonzero path
  (``_eval_valid``) on the same batch: the same samples through the same
  plain versions, so rtol 1e-6 with atol 1e-6 of the largest value (the
  MLPs' matmuls see more rows, which may change their blocking).
* The encoders' valid count: the first ``count`` rows bit for bit as
  without it, the rest zero, and no gradient from them.
* The occupancy refresh in place, bit for bit the out-of-place one.
* Adam's restored ``step`` for a capturable group; :meth:`NeRFSystem.
  fused_ok`'s rule; a small ``fit`` across ``FLAT_AFTER``; and the fused
  runner's control flow (warm-up, capture, replay, the padded step's graph
  dropped for the flat one's, refresh parity, launch counts, rebinding;
  also on a five-cascade scene with erode and ``--use_exposure``) with
  CUDA graphs replaced by a stand-in that records the captured function
  and runs it again on each replay, against the eager trainer, bit for
  bit. tests/test_torch_padded.py holds the padded step.
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

from mfnerf_tpu_torch import losses as tlosses
from mfnerf_tpu_torch import train as ttrain
from mfnerf_tpu_torch.datasets.memory import MemoryDataset
from mfnerf_tpu_torch.models import ngp as tngp
from mfnerf_tpu_torch.models import rendering as trendering
from mfnerf_tpu_torch.ops import hashgrid as thash
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.parallel import dist as pdist
from mfnerf_tpu_torch.utils import ckpt as tckpt
from mfnerf_tpu_torch.utils.ckpt import params_from_numpy
from mfnerf_tpu_torch.utils.procedural import make_scene

from test_torch_train import (HASH, SMALL, _batch, _close, _hparams,
                              _one_torch_thread, _t)

assert _one_torch_thread       # the autouse fixture, for this module too

FRAME_ATOL = 1e-5
LOSS_RTOL, GRAD_RTOL, GRAD_REL_ATOL = 1e-5, 1e-4, 1e-5
SELF_RTOL = 1e-6            # capacity against the nonzero path, same ops
N_RAYS = 256


def _flat_models(grid):
    cfg = dict(SMALL, grid=grid)
    if grid != "LowRank":
        cfg.update(HASH, N_tables=2, hash_grad_samples=4)
    jmodel = jngp.NGP(jngp.NGPConfig(max_samples=256, **cfg))
    params = jmodel.init(jax.random.PRNGKey(1))
    tmodel = tngp.NGP(tngp.NGPConfig(**cfg), device="cpu")
    tmodel.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, tmodel


# (s_flat, s_max_train, fill): the cut binds (N * s_flat slots, all valid);
# the batch under the budget; no valid sample; every (N, S) slot valid
CASES = {"cut": (4, 32, 0x33), "under": (16, 32, 0x01),
         "empty": (4, 32, 0x00), "full": (16, 8, 0xFF)}


def _case_batch(case, seed):
    """_batch's rays for ``case``; for "full" every cell is occupied and the
    rays (none missing) cross the box from face to face, so that every
    slot is valid."""
    bits, rays_o, rays_d, noise, target = _batch(n=N_RAYS, seed=seed,
                                                 fill=CASES[case][2])
    if case == "full":
        bits[:] = 0xFF
        d = rays_d[1:2] * np.float32([0.2, 0.2, 1.0]) + np.random.default_rng(
            seed).normal(size=(N_RAYS, 3)).astype(np.float32) \
            * np.float32([0.02, 0.02, 0.0])
        rays_d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
            np.float32)
    return bits, rays_o, rays_d, noise, target


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("grid", ["LowRank", "MixedFeature"])
def test_capacity_matches_jax_flat_render_train(grid, case):
    """render_train with ``s_flat`` (the capacity layout) against the JAX
    render_train's flat branch, its loss and every parameter gradient. The
    JAX side runs under jit for LowRank (the unfused fp32 encoder) and op
    by op for the hash grid (XLA may contract its x * scale + 0.5)."""
    s_flat, s_max, _ = CASES[case]
    jmodel, params, tmodel = _flat_models(grid)
    bits, rays_o, rays_d, _, target = _case_batch(case, 2)
    rcfg_kw = dict(s_max_train=s_max, max_samples=256, s_flat=s_flat)
    key = jax.random.PRNGKey(3)
    k_noise, _, k_gn = jax.random.split(key, 3)
    noise = np.asarray(jax.random.uniform(k_noise, (N_RAYS,)))
    grad_noise = None
    if grid != "LowRank":
        grad_noise = np.asarray(jax.random.uniform(
            k_gn, (N_RAYS * s_flat, 4)))
    occ_j = dataclasses.replace(
        jngp.OccupancyState.create(jmodel.cfg),
        density_bitfield=jnp.asarray(bits)).refresh_coarse(jmodel.cfg)
    rcfg_j = jrendering.RenderConfig(**rcfg_kw)
    loss_j_mod = jlosses.NeRFLoss()

    def loss_j(p):
        res = jrendering.render_train(jmodel, p, occ_j, jnp.asarray(rays_o),
                                      jnp.asarray(rays_d), key, rcfg_j)
        terms = loss_j_mod(res, {"rgb": jnp.asarray(target)})
        return sum(v.mean() for v in terms.values()), res

    step = jax.value_and_grad(loss_j, has_aux=True)
    if grid == "LowRank":
        (lj, want), grads_j = jax.jit(step)(params)
    else:
        with jax.disable_jit():
            (lj, want), grads_j = step(params)

    occ_t = dataclasses.replace(tngp.OccupancyState.create(tmodel.cfg, "cpu"),
                                density_bitfield=_t(bits)
                                ).refresh_coarse(tmodel.cfg)
    got = trendering.render_train(
        tmodel, occ_t, _t(rays_o), _t(rays_d), _t(noise),
        trendering.RenderConfig(**rcfg_kw),
        grad_noise=None if grad_noise is None else _t(grad_noise))
    lt = sum(v.mean() for v in tlosses.NeRFLoss()(
        got, {"rgb": _t(target)}).values())
    lt.backward()

    n_valid = int(got["mask"].sum())
    assert int(got["vr_samples"]) == n_valid
    assert int(got["rm_samples"]) == int(want["rm_samples"])
    cap = min(N_RAYS * s_max, N_RAYS * s_flat)
    if case == "cut":
        assert n_valid == cap < int(got["rm_samples"])
    elif case == "under":
        assert 0 < n_valid < cap
    elif case == "empty":
        assert n_valid == 0
    else:
        assert n_valid == cap == N_RAYS * s_max
    counts_j = np.bincount(np.asarray(want["ray_id_flat"])[:n_valid],
                           minlength=N_RAYS)
    np.testing.assert_array_equal(got["mask"].numpy().sum(axis=1), counts_j)
    for key_ in ("rgb", "opacity", "depth"):
        np.testing.assert_allclose(got[key_].detach().numpy(),
                                   np.asarray(want[key_]), atol=FRAME_ATOL)
    np.testing.assert_allclose(float(lt.detach()), float(lj),
                               rtol=LOSS_RTOL)
    want_g = params_from_numpy(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in tmodel.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        if case == "empty":       # nothing reached the field
            assert not g.any() and not w.any(), name
            continue
        assert np.abs(g).max() > 0, name
        _close(g, w, rtol=GRAD_RTOL, rel_atol=GRAD_REL_ATOL)


def _nonzero(model, xyzs, rays_d, mask, cap, grad_noise=None, exposure=None,
             noise_start=None, by_entry=False):
    """The capacity layout's reference: the same samples through the
    nonzero path (valid sample j takes the uniforms' row j, or with
    ``by_entry`` the row of its entry)."""
    if grad_noise is not None:
        grad_noise = grad_noise[mask.reshape(-1)] if by_entry \
            else grad_noise[:int(mask.sum())]
    return trendering._eval_valid(model, xyzs, rays_d, mask, grad_noise,
                                  exposure)


@pytest.mark.parametrize("case", ["cut", "under", "full"])
@pytest.mark.parametrize("grid,fused", [("LowRank", True),
                                        ("MixedFeature", False)])
def test_capacity_matches_nonzero_path(grid, fused, case, monkeypatch):
    """The capacity layout against ``_eval_valid`` on the same batch: the
    fused LowRank encoder (hat_prod with the count) and the hash grid with
    sampled corners; outputs and every gradient."""
    s_flat, s_max, _ = CASES[case]
    cfg = dict(SMALL, grid=grid, lr_fused=fused)
    if grid != "LowRank":
        cfg.update(HASH, N_tables=2, hash_grad_samples=4)
    model = tngp.NGP(tngp.NGPConfig(**cfg), torch.Generator().manual_seed(5),
                     device="cpu")
    bits, rays_o, rays_d, noise, target = _case_batch(case, 4)
    occ = dataclasses.replace(tngp.OccupancyState.create(model.cfg, "cpu"),
                              density_bitfield=_t(bits)
                              ).refresh_coarse(model.cfg)
    rcfg = trendering.RenderConfig(s_max_train=s_max, max_samples=256,
                                   s_flat=s_flat)
    grad_noise = None
    if grid != "LowRank":
        grad_noise = torch.from_numpy(np.random.default_rng(6).random(
            (N_RAYS * s_flat, 4), dtype=np.float32))
    runs = {}
    for label in ("capacity", "nonzero"):
        with contextlib.ExitStack() as stack:
            if label == "nonzero":
                stack.enter_context(monkeypatch.context()).setattr(
                    trendering, "_eval_capacity", _nonzero)
            model.zero_grad(set_to_none=True)
            res = trendering.render_train(model, occ, _t(rays_o),
                                          _t(rays_d), _t(noise), rcfg,
                                          grad_noise=grad_noise)
            loss = sum(v.mean() for v in tlosses.NeRFLoss()(
                res, {"rgb": _t(target)}).values())
            loss.backward()
        runs[label] = (res, float(loss.detach()),
                       {k: p.grad.clone() for k, p in
                        model.named_parameters()})
    (res_c, loss_c, g_c), (res_n, loss_n, g_n) = runs["capacity"], \
        runs["nonzero"]
    assert torch.equal(res_c["mask"], res_n["mask"])
    for key in ("rgb", "opacity", "depth", "ws"):
        _close(res_c[key].detach(), res_n[key].detach(), rtol=SELF_RTOL,
               rel_atol=SELF_RTOL)
    np.testing.assert_allclose(loss_c, loss_n, rtol=SELF_RTOL)
    for name in g_n:
        assert g_n[name].abs().max() > 0, name
        _close(g_c[name], g_n[name], rtol=SELF_RTOL, rel_atol=SELF_RTOL)


def _hat_set(n=700, k=33, r=16, seed=8):
    rng = np.random.default_rng(seed)
    u3 = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
    w3 = torch.from_numpy(rng.normal(size=(3, k, r)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32))
    return u3, w3, k, g


def _hash_set(n=700, seed=9, m=8):
    cfg = tngp.NGPConfig(grid="MixedFeature", N_tables=2,
                         hash_grad_samples=m, **HASH).hash_cfg
    rng = np.random.default_rng(seed)
    params = torch.from_numpy(rng.normal(
        size=(cfg.n_params, cfg.F)).astype(np.float32))
    x = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
    g = torch.from_numpy(rng.normal(size=(n, cfg.out_dim)).astype(
        np.float32))
    noise = torch.from_numpy(rng.random((n, m), dtype=np.float32)) \
        if m < 8 else None
    return cfg, params, x, g, noise


@pytest.mark.parametrize("count", [0, 1, 313, 700])
@pytest.mark.parametrize("encoder", ["hat-bf16", "hat-fp32", "hash-exact",
                                     "hash-sampled"])
def test_encoder_count_keeps_the_valid_rows(encoder, count):
    """With ``count`` the first ``count`` rows are bit for bit the encoder
    on those rows alone and the rest zero; the rows past it give no
    gradient (du and d_x 0, nothing added to dW or d_params). The rows'
    outputs and du or d_x are bit for bit those of the version without
    the count on all N rows, and within SELF_RTOL of the version on the
    first rows alone, as dW and d_params are (the plain versions' matmuls
    then have other shapes, and BLAS another blocking; the hash grid's and
    the bf16 hat forward's are the same bit for bit)."""
    c = torch.tensor([count])
    if encoder.startswith("hat"):
        dtype = "bfloat16" if encoder == "hat-bf16" else "float32"
        u3, w3, k, g = _hat_set()
        out = thatmul.hat_prod_plain(u3, w3, k, dtype, count=c)
        out_all = thatmul.hat_prod_plain(u3, w3, k, dtype)
        head = thatmul.hat_prod_plain(u3[:count], w3, k, dtype)
        du, dw = thatmul.hat_prod_bwd_plain(u3, w3, k, g, True, dtype,
                                            count=c)
        du_h, dw_h = thatmul.hat_prod_bwd_plain(u3[:count], w3, k,
                                                g[:count], True, dtype)
        du_all = thatmul.hat_prod_bwd_plain(u3, w3, k, g, True, dtype)[0]
        # autograd through hat_prod reaches the same plain backward
        u_req = u3.clone().requires_grad_()
        w_req = w3.clone().requires_grad_()
        thatmul.hat_prod(u_req, w_req, k, dtype, count=c).backward(g)
        assert torch.equal(u_req.grad, du) and torch.equal(w_req.grad, dw)
    else:
        cfg, params, x, g, noise = _hash_set(
            m=4 if encoder == "hash-sampled" else 8)
        out = thash.hashgrid_encode_plain(params, x, cfg, count=c)
        out_all = thash.hashgrid_encode_plain(params, x, cfg)
        head = thash.hashgrid_encode_plain(params, x[:count], cfg)
        assert torch.equal(out[:count], head)
        dw, du, _ = thash.hashgrid_bwd_plain(params, x, cfg, g,
                                             grad_noise=noise, count=c)
        dw_h, du_h, _ = thash.hashgrid_bwd_plain(
            params, x[:count], cfg, g[:count],
            grad_noise=None if noise is None else noise[:count])
        du_all = thash.hashgrid_bwd_plain(params, x, cfg, g,
                                          grad_noise=noise)[1]
        p_req = params.clone().requires_grad_()
        x_req = x.clone().requires_grad_()
        thash.hashgrid_encode(p_req, x_req, cfg, grad_noise=noise,
                              count=c).backward(g)
        assert torch.equal(p_req.grad, dw) and torch.equal(x_req.grad, du)
    assert torch.equal(out[:count], out_all[:count])
    assert not out[count:].any()
    _close(out[:count], head, rtol=SELF_RTOL, rel_atol=SELF_RTOL) \
        if count else None
    assert torch.equal(du[:count], du_all[:count]) and not du[count:].any()
    if count == 0:
        assert not dw.any()
        return
    _close(du[:count], du_h, rtol=SELF_RTOL, rel_atol=SELF_RTOL)
    _close(dw, dw_h, rtol=SELF_RTOL, rel_atol=SELF_RTOL)


def _occupancy(model, seed, erode):
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    shape = (cfg.cascades, cfg.n_cells)
    grid = rng.random(shape, dtype=np.float32) * 20.0
    grid[rng.random(shape) < 0.1] = -1.0           # culled cells
    occ = tngp.OccupancyState.create(cfg, "cpu")
    occ.density_grid = _t(grid)
    if erode:
        occ.count_grid = _t(rng.random(shape, dtype=np.float32))
    return occ


@pytest.mark.parametrize("erode", [False, True])
@pytest.mark.parametrize("half", [None, 0, 1])
@pytest.mark.parametrize("scale", [0.5, 2.0, 8.0])
def test_refresh_in_place_is_the_refresh(scale, half, erode):
    """update_density_grid(in_place=True) writes bit for bit the state the
    out-of-place refresh returns into the state's own tensors, fresh
    stage-A grids (one cascade) or union grid (three cascades, and the
    five of ``--scale 8``) included."""
    model = tngp.NGP(tngp.NGPConfig(scale=scale, **SMALL),
                     torch.Generator().manual_seed(2), device="cpu")
    cfg = model.cfg
    n = cfg.n_cells if half is None else cfg.n_cells // 2
    noise = torch.from_numpy(np.random.default_rng(3).random(
        (cfg.cascades, n, 3), dtype=np.float32)) * 2 - 1
    thr = 0.01 * 1024 / np.sqrt(3)
    occ = _occupancy(model, 4, erode)
    want = model.update_density_grid(
        dataclasses.replace(occ, density_grid=occ.density_grid.clone()),
        thr, noise, half=half, erode=erode)
    ptrs = [t.data_ptr() for t in (occ.density_grid, occ.density_bitfield)]
    got = model.update_density_grid(occ, thr, noise, half=half, erode=erode,
                                    in_place=True)
    assert got is occ
    assert ptrs == [t.data_ptr() for t in (occ.density_grid,
                                           occ.density_bitfield)]
    assert occ.derived_from is occ.density_bitfield
    for name in ("density_grid", "density_bitfield", "stage_a",
                 "union_bits"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    if cfg.cascades == 1:
        assert got.stage_a is not None and got.stage_a.any()
    else:
        assert got.union_bits is not None


def test_adam_step_restored_onto_a_capturable_groups_device():
    """adam_state_from_numpy: ``step`` of a capturable group (the trainer's
    on the card) comes back on the parameter's device as float32, from a
    JAX checkpoint's int32 count too; a plain group keeps it on the CPU as
    saved. The moments round-trip bit for bit either way."""
    model = torch.nn.Linear(3, 2, bias=False)
    for capturable in (False, True):
        opt = torch.optim.Adam(model.parameters(), capturable=capturable)
        w = model.weight
        section = {"exp_avg/weight": np.full((2, 3), 0.5, np.float32),
                   "exp_avg_sq/weight": np.full((2, 3), 0.25, np.float32),
                   "step/weight": np.array(7, np.int32)}
        tckpt.adam_state_from_numpy(opt, model, section)
        state = opt.state[w]
        assert state["step"].device == (w.device if capturable
                                        else torch.device("cpu"))
        assert state["step"].dtype == (torch.float32 if capturable
                                       else torch.int32)
        assert float(state["step"]) == 7.0
        back = tckpt.adam_state_to_numpy(opt, model)
        for key in ("exp_avg/weight", "exp_avg_sq/weight"):
            np.testing.assert_array_equal(back[key], section[key])


def _fused_system(exposures=False, **kw):
    """A trainer on a 16x16 procedural scene; with ``exposures`` its rays
    carry each image's exposure (HDR-NeRF data, unit-exposure rgb 0.73)."""
    scene = make_scene(n_train=4, n_test=1, wh=16, seed=0)
    hp = dict(s_flat=4, pool_a=4, steps_per_epoch=600, batch_size=256)
    hp.update(kw)
    system = ttrain.NeRFSystem(_hparams(**hp), device="cpu")
    train = MemoryDataset.from_scene(scene, "train")
    if exposures:
        train.rays = np.concatenate([train.rays, np.broadcast_to(
            np.float32([0.5, 1.0, 2.0, 0.25])[:, None, None],
            (*train.rays.shape[:2], 1))], axis=2)
        train.unit_exposure_rgb = 0.73
    system.setup(train)
    system.configure(0)
    return system


@pytest.mark.parametrize("rule", ["served", "warm-up", "cpu", "group",
                                  "group-nccl", "s_flat0", "ext",
                                  "exposure"])
def test_fused_ok_rule(rule, capsys, monkeypatch):
    """The fused runner serves every step on CUDA, outside a process group
    or inside an NCCL one ("group-nccl", one card a rank), with or without
    --optimize_ext ("ext"): the padded step from step 0 ("warm-up") and
    the flat one from FLAT_AFTER ("served"), multi-cascade scenes' padded
    step to the end ("s_flat0"), and --use_exposure's steps; not on the
    CPU or in a gloo process group ("group"), each logged with its reason.
    The decision is printed once."""
    system = _fused_system()
    system.global_step = ttrain.FLAT_AFTER
    if rule != "cpu":      # the rule reads the device type alone
        system.device = torch.device("cuda", 0)
    if rule == "warm-up":
        system.global_step = 0
    elif rule in ("group", "group-nccl"):
        monkeypatch.setattr(pdist, "in_group", lambda group=None: True)
        monkeypatch.setattr(pdist, "backend", lambda: "gloo"
                            if rule == "group" else "nccl")
    elif rule == "s_flat0":
        system.rcfg = dataclasses.replace(system.rcfg, s_flat=0)
    elif rule == "ext":
        system.hparams.optimize_ext = True
    elif rule == "exposure":
        system.use_exposure = True
    served = rule not in ("cpu", "group")
    assert [system.fused_ok() for _ in range(2)] == [served] * 2
    out = capsys.readouterr().out
    assert out.count("fused runner") == 1
    assert ("CUDA graphs" in out) == served
    why = {"cpu": "not on a CUDA device",
           "group": "inside a gloo process group: gloo collectives cannot "
                    "be captured"}
    assert (f"off ({why[rule]})" in out) if rule in why else "off" not in out
    assert ("in an NCCL process group of 1 rank" in out) == \
        (rule == "group-nccl")
    if served:
        assert "padded step from step 0" in out if rule != "s_flat0" \
            else "padded step (s_flat 0) from step 0 to the end" in out
        assert (f"flat step from step {ttrain.FLAT_AFTER}" in out) == \
            (rule != "s_flat0")


def test_fit_across_flat_after():
    """A CPU fit across FLAT_AFTER (every step eager: no card): each step's
    metrics, the schedule's rate, the refreshes every UPDATE_INTERVAL steps
    and, past FLAT_AFTER, at most s_flat samples a ray composited."""
    system = _fused_system()
    system.fit(1)
    start = ttrain.FLAT_AFTER - 20
    system.set_step(start)
    n_refresh = system.n_refresh
    m = system.fit(40)
    assert system.global_step == start + 40
    assert set(m) == {"loss", "psnr", "rm_s", "vr_s", "lr"}
    assert all(v.shape == (40,) and v.dtype == torch.float32
               for v in m.values())
    assert torch.isfinite(m["loss"]).all()
    assert system.n_refresh == n_refresh + 3       # steps 496, 512, 528
    flat = 20                                      # the first step >= 512
    assert (m["vr_s"][flat:] <= system.rcfg.s_flat).all()
    assert (m["vr_s"][:flat] > system.rcfg.s_flat).any()
    assert torch.equal(m["lr"], torch.full((40,), system.schedule(start)))


class _Graph:
    """A stand-in for a captured CUDA graph on the CPU: its replay runs the
    captured function again and writes its output into the static output
    that the capture returned, as a graph's kernels overwrite theirs."""

    def __init__(self, fn, generator):
        self.fn, self.generators = fn, [generator]
        self.out = torch.empty(len(ttrain.METRICS))

    def replay(self):
        out = self.fn()
        if out is not None:
            self.out.copy_(out)

    def reset(self):
        self.fn = None


def _stand_in_runner(system, monkeypatch):
    """The system's fused runner on the CPU: its side stream a no-op, its
    captures :class:`_Graph` stand-ins that record the function and run
    nothing, and the rule serving every step. Returns
    (the runner, the step kinds of its step captures, in order)."""
    kinds = []

    def capture(self, fn):
        if getattr(fn, "__func__", None) is ttrain.NeRFSystem._device_step:
            kinds.append(self.kind)
        graph = _Graph(fn, self.system.generator)
        self.launches[graph] = {}
        return graph, graph.out

    stream = type("Stream", (), {"wait_stream": lambda self, other: None})()
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(ttrain.FusedRunner, "_capture", capture)
    monkeypatch.setattr(ttrain.NeRFSystem, "fused_ok", lambda self: True)
    return system.make_fused_train_fn(), kinds


def _fit_history(system):
    """fit(2) from step 0, 7 steps across FLAT_AFTER - 5, then 17 and 23
    more (blocks of 16 started and ended mid-way): their metrics."""
    system.fit(2)
    system.set_step(ttrain.FLAT_AFTER - 5)
    return [system.fit(7), system.fit(17), system.fit(23)]


def _adam_states_equal(a, b):
    """Whether two trainers' Adam states (every group's, parameter by
    parameter) are equal bit for bit."""
    pa = [p for g in a.optimizer.param_groups for p in g["params"]]
    pb = [p for g in b.optimizer.param_groups for p in g["params"]]
    return len(pa) == len(pb) and all(
        a.optimizer.state[x].keys() == b.optimizer.state[y].keys()
        and all(torch.equal(v, b.optimizer.state[y][k])
                for k, v in a.optimizer.state[x].items())
        for x, y in zip(pa, pb))


@pytest.mark.parametrize("grid", ["LowRank", "MixedFeature",
                                  "cascades-exposure", "ext"])
def test_fused_runner_control_flow_matches_eager(grid, monkeypatch):
    """The runner's control flow on the CPU, its graphs replaced by a
    stand-in that runs the captured function again on each replay: the
    same history through the runner and eagerly gives the same metrics,
    parameters, Adam state and bitfield bit for bit (warm-up steps, the
    step's capture and replays, the padded step's graph dropped for the
    flat one's at FLAT_AFTER, the refresh graphs of both parities, a
    refresh parity that alternates over the whole run, fit calls that
    start and end mid-block, graphs kept across fit calls).
    "cascades-exposure": a five-cascade scene (--scale 8: the padded step
    to the end, the union grid's refresh) with the colmap refresh's erode,
    --use_exposure (rays with an exposure column) and --random_bg. "ext":
    LowRank under --optimize_ext at a --pose_lr that moves dR and dT,
    which with their Adam group are held bit for bit too. Then a replaced
    occupancy is copied into the captured one, and a replaced parameter
    (under --optimize_ext: dT) makes the runner capture anew after new
    warm-up steps."""
    kw = dict(grid=grid) if grid == "LowRank" else dict(
        grid=grid, T=14, N_max=128, N_tables=2, hash_grad_samples=4)
    if grid == "cascades-exposure":
        kw = dict(scale=8.0, dataset_name="colmap", use_exposure=True,
                  random_bg=True, exposures=True, batch_size=128)
    elif grid == "ext":
        kw = dict(grid="LowRank", optimize_ext=True, pose_lr=1e-3)
    eager = _fused_system(**kw)
    assert eager.erode == (grid == "cascades-exposure")
    want = _fit_history(eager)

    system = _fused_system(**kw)
    runner, kinds = _stand_in_runner(system, monkeypatch)
    got = _fit_history(system)
    assert system.fused is runner
    assert kinds == (["padded"] if grid == "cascades-exposure"
                     else ["padded", "flat"])
    assert runner.step_graph is not None and runner.warm == \
        ttrain.FUSED_WARMUP
    assert set(runner.refresh_graphs) == {0, 1}
    for g in (runner.step_graph, *runner.refresh_graphs.values()):
        assert g.generators == [system.generator]
    assert system.n_refresh == eager.n_refresh
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            assert torch.equal(w[key], g[key]), key
    for (name, a), b in zip(eager.model.state_dict().items(),
                            system.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert set(eager.ext) == set(system.ext) == (
        {"dR", "dT"} if grid == "ext" else set())
    for name, a in eager.ext.items():
        assert a.abs().max() > 0, name     # the poses moved
        assert torch.equal(a, system.ext[name]), name
    assert _adam_states_equal(eager, system)
    assert torch.equal(eager.occ.density_bitfield,
                       system.occ.density_bitfield)

    occ = system.occ           # a replaced occupancy is copied in
    system.occ = dataclasses.replace(
        occ, density_grid=occ.density_grid.clone() + 1.0,
        density_bitfield=occ.density_bitfield.clone() ^ 1
    ).refresh_coarse(system.model_cfg)
    new_bits = system.occ.density_bitfield.clone()
    runner.bind()
    assert system.occ is occ and torch.equal(occ.density_bitfield, new_bits)
    assert runner.step_graph is not None
    if grid == "ext":                     # a replaced pose correction
        first = system.ext["dT"]
        system.ext["dT"] = torch.nn.Parameter(first.detach().clone())
        replaced, groups = system.ext["dT"], \
            system.optimizer.param_groups[1]["params"]
    else:                                 # a replaced parameter
        first = system.model.sigma_mlp[0]
        system.model.sigma_mlp[0] = torch.nn.Parameter(
            first.detach().clone())
        replaced, groups = system.model.sigma_mlp[0], \
            system.optimizer.param_groups[0]["params"]
    groups[next(i for i, p in enumerate(groups) if p is first)] = replaced
    system.fit(1)
    assert system.fused is runner and runner.step_graph is None \
        and runner.warm == 1
