"""What the march and composite wrappers hand their kernels, on the host.

``ops/ray_march.py::march_params`` gives the training march kernel its
strata (stage A, a lane a stratum) for the bench, MixedFeature and
five-cascade recipes, and ``ops/composite.py::bwd_passes`` picks the
training forward's and backward's template (P passes of a row in
registers, or 0: the pass-by-pass forward and the two-walk backward). The kernels run only on the card (``chip_smoke.py`` holds every
variant bit for bit to the plain versions there); here the parameters and
choices are held to what the kernels take, for those recipes and at their
limits, and the wrappers are held to hand the kernels what they chose (the
C entry points replaced by recorders) and to refuse what the kernels do
not take; so are the encoder wrappers' valid count (the capacity
layout's, which the four encoder kernels read on the device).
"""
import pytest
import torch

from mfnerf_tpu_torch.models.ngp import NGPConfig
from mfnerf_tpu_torch.models.rendering import RenderConfig
from mfnerf_tpu_torch.ops import composite as tcomposite
from mfnerf_tpu_torch.ops import hashgrid as thash
from mfnerf_tpu_torch.ops import hatmul as thatmul
from mfnerf_tpu_torch.ops import ray_march as tmarch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recipe_params(recipe, s_strata=32):
    """march_params of a recipe's training step: bench / mf (one cascade,
    scale 0.5, grid 128, the two-level strata on the grid pooled 2) or
    cascades (scale 8, five cascades, exponential steps, the union grid)."""
    if recipe == "cascades":
        rcfg = RenderConfig(exp_step_factor=1 / 256)
        scale, cascades = 8.0, 5
        stratum, _ = tmarch.cascades_stratum(1 / 256, scale, cascades)
        strata = tmarch.Strata(torch.zeros(128 ** 3 // 8, dtype=torch.uint8),
                               stratum, s_strata, 1.0, union=True)
    else:
        rcfg = RenderConfig()
        scale, cascades = 0.5, 1
        stratum = tmarch.twolevel_stratum(0.0, rcfg.max_samples, scale, 128,
                                          cascades)
        strata = tmarch.Strata(torch.zeros((64,) * 3, dtype=torch.bool),
                               stratum, s_strata, 1.0)
    n_rungs = rcfg.n_rungs(scale, 128)
    return tmarch.march_params(scale, rcfg.exp_step_factor, 128, cascades,
                               rcfg.max_samples, scale, n_rungs,
                               rcfg.s_max_train, strata=strata)


@pytest.mark.parametrize("recipe,n_strata,stratum,n_probes,mode", [
    ("bench", 34, 32, 2, 1),     # 1,025 rungs: two stage-A passes a warp
    ("mf", 34, 32, 2, 1),
    ("cascades", 165, 8, 0, 2),  # 1,318 rungs: six passes of the union
])
def test_recipes_march_params(recipe, n_strata, stratum, n_probes, mode):
    """The strata that the kernel's stage A walks for each recipe's
    training step, within what the kernel takes."""
    p = _recipe_params(recipe)
    assert (p.n_strata, p.stratum, p.n_probes, p.mode, p.s_strata) == (
        n_strata, stratum, n_probes, mode, 32)
    assert p.n_strata * p.stratum >= p.n_rungs
    tmarch._check_counts(p, p.n_rungs, p.s_max)


def _cpu_march_args(n=16, n_rungs=300, s_max=16):
    g = 32
    rays_o = torch.zeros((n, 3))
    rays_d = torch.nn.functional.normalize(torch.ones((n, 3)), dim=1)
    hits = torch.tensor([[0.1, 0.9]]).repeat(n, 1)
    bits = torch.zeros(g ** 3 // 8, dtype=torch.uint8)
    return (rays_o, rays_d, hits, bits, 1, 0.5, 0.0, g, 128,
            torch.zeros(n), n_rungs, s_max)


def test_march_wrapper_hands_the_kernel_its_rays(monkeypatch):
    """_launch_train passes the ray count and the strata's parameters,
    and counts one launch a call."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tmarch, "_kernels", lambda: (record, None))
    monkeypatch.setattr(tmarch, "_stream", lambda device: 0)
    launches = tmarch.march_rays_train.launches
    tmarch._launch_train(*_cpu_march_args(), 0.5, 0, None)
    assert calls[-1][1] == 16
    assert calls[-1][0]._obj.mode == 0
    strata = tmarch.Strata(torch.zeros((16,) * 3, dtype=torch.bool), 8, 1,
                           1.0)
    want = tmarch.march_params(0.5, 0.0, 32, 1, 128, 0.5, 2000, 16,
                               strata=strata)
    assert want.n_strata * 8 >= 2000
    for n in (1024, 4096):
        tmarch._launch_train(*_cpu_march_args(n=n, n_rungs=2000), 0.5, 0,
                             strata)
        p = calls[-1][0]._obj
        assert calls[-1][1] == n
        assert bytes(p) == bytes(want)
    assert tmarch.march_rays_train.launches == launches + 3
    tmarch.march_rays_train.launches = launches


@pytest.mark.parametrize("change", [
    dict(n_rungs=0), dict(n_rungs=2 ** 24), dict(s_max=0),
    dict(n_strata=tmarch.MAX_STRATA + 1),
    dict(s_strata=tmarch.MAX_CHOSEN + 1)])
def test_check_counts_refuses_what_the_kernels_do_not_take(change):
    p = _recipe_params("bench")
    n_rungs, s_max = change.pop("n_rungs", p.n_rungs), change.pop(
        "s_max", p.s_max)
    for name, value in change.items():
        setattr(p, name, value)
    with pytest.raises(ValueError):
        tmarch._check_counts(p, n_rungs, s_max)


def test_check_counts_takes_the_limits():
    p = _recipe_params("cascades")
    p.n_strata, p.s_strata = tmarch.MAX_STRATA, tmarch.MAX_CHOSEN
    tmarch._check_counts(p, 2 ** 24 - 1, 1)


def test_too_many_probes_are_refused():
    """A stratum whose probes exceed the kernel's MAX_PROBES raises."""
    strata = tmarch.Strata(torch.zeros((16,) * 3, dtype=torch.bool), 32, 32,
                           64.0)
    with pytest.raises(ValueError, match="probes"):
        tmarch.march_params(0.5, 0.0, 128, 1, 1024, 0.5, 1025, 64,
                            strata=strata)


@pytest.mark.parametrize("s,width,passes", [
    (1, 1, 1), (8, 8, 1), (16, 16, 1), (17, 32, 1), (32, 32, 1),
    (33, 32, 2), (40, 32, 2), (64, 32, 2), (65, 32, 4), (128, 32, 4),
    (129, 32, 0), (200, 32, 0), (49152, 32, 0)])
def test_bwd_passes_cover_the_row(s, width, passes):
    """P is the fewest of 1, 2, 4 passes of row_width(s) slots that cover
    the row; longer rows take the two-walk kernel (0)."""
    assert tcomposite.row_width(s) == width
    assert tcomposite.bwd_passes(s) == passes
    if passes:
        assert -(-s // width) <= passes


def _cpu_block(n, s):
    return (torch.rand((n, s)), torch.rand((n, s, 3)), torch.rand((n, s)),
            torch.rand((n, s)), torch.ones((n, s), dtype=torch.bool))


def test_bwd_wrapper_hands_the_kernel_its_passes(monkeypatch):
    """_launch_train_bwd passes bwd_passes(s), or the passes it is given,
    for every s up to MAX_BWD_SLOTS, and refuses longer rows before any
    launch."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tcomposite, "_kernels",
                        lambda: (None, record, None))
    monkeypatch.setattr(tcomposite, "_stream", lambda device: 0)
    launches = tcomposite.composite_train_bwd.launches
    needs = (True, True, False, False)
    for s in (8, 40, 64, 128, 200, tcomposite.MAX_BWD_SLOTS):
        outs = tcomposite._launch_train_bwd(*_cpu_block(2, s), None, None,
                                            None, None, 1e-4, needs)
        assert calls[-1][:3] == (2, s, tcomposite.bwd_passes(s))
        assert [o is not None for o in outs] == list(needs)
    tcomposite._launch_train_bwd(*_cpu_block(2, 64), None, None, None, None,
                                 1e-4, needs, passes=0)
    assert calls[-1][:3] == (2, 64, 0)
    n_calls = len(calls)
    with pytest.raises(ValueError, match="at most"):
        tcomposite._launch_train_bwd(
            *_cpu_block(1, tcomposite.MAX_BWD_SLOTS + 1), None, None, None,
            None, 1e-4, needs)
    assert len(calls) == n_calls
    tcomposite.composite_train_bwd.launches = launches


def test_fwd_wrapper_hands_the_kernel_its_passes(monkeypatch):
    """_launch_train_fwd passes bwd_passes(s), the backward's P, and so 0
    (the pass-by-pass kernel) for rows of more than 128 slots, or the
    passes it is given; one launch a call."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tcomposite, "_kernels",
                        lambda: (record, None, None))
    monkeypatch.setattr(tcomposite, "_stream", lambda device: 0)
    launches = tcomposite.composite_train.launches
    sizes = (1, 8, 40, 64, 128, 129, 200, tcomposite.MAX_BWD_SLOTS + 1)
    for s in sizes:
        outs = tcomposite._launch_train_fwd(*_cpu_block(2, s), 1e-4)
        assert calls[-1][:4] == (2, s, tcomposite.bwd_passes(s), 1e-4)
        assert (calls[-1][2] == 0) == (s > 128)
        assert [tuple(o.shape) for o in outs] == [(2,), (2,), (2, 3),
                                                  (2, s), (2,)]
    tcomposite._launch_train_fwd(*_cpu_block(2, 64), 1e-4, passes=0)
    assert calls[-1][:3] == (2, 64, 0)
    assert tcomposite.composite_train.launches == launches + len(sizes) + 1
    tcomposite.composite_train.launches = launches


def _encoder_launch(encoder, count):
    """One call of ``encoder``'s wrapper on small CPU operands."""
    gen = torch.Generator().manual_seed(0)
    if encoder.startswith("hat"):
        u3 = torch.rand((64, 3), generator=gen)
        w3 = torch.rand((3, 9, 8), generator=gen)
        if encoder == "hat_fwd":
            return thatmul._launch(u3, w3, 9, count=count)
        return thatmul._launch_bwd(u3, w3, 9, torch.rand((64, 8)), True,
                                   count=count)
    cfg = NGPConfig(grid="Hash", L=4, log2_T=10, N_max=64).hash_cfg
    params = torch.rand((cfg.n_params, cfg.F), generator=gen)
    x = torch.rand((64, 3), generator=gen)
    if encoder == "hash_fwd":
        return thash._launch_fwd(params, x, cfg, None, count=count)
    return thash._launch_bwd(params, x, cfg, torch.rand((64, cfg.out_dim)),
                             None, None, True, count=count)


@pytest.mark.parametrize("encoder", ["hat_fwd", "hat_bwd", "hash_fwd",
                                     "hash_bwd"])
def test_encoder_wrappers_hand_the_kernels_the_count(encoder, monkeypatch):
    """Each encoder wrapper hands its kernel the valid count's device
    pointer just before the stream (None without a count), one launch a
    call, and refuses a count that is not one int64 on the operands'
    device before any launch."""
    calls = []

    def record(*args):
        calls.append(args)
        return 0

    module = thatmul if encoder.startswith("hat") else thash
    monkeypatch.setattr(module, "_kernels", lambda *dtype: (record, record))
    monkeypatch.setattr(module, "_stream", lambda device: 0)
    counter = {"hat_fwd": thatmul.hat_prod, "hat_bwd": thatmul.hat_prod_bwd,
               "hash_fwd": thash.hashgrid_encode,
               "hash_bwd": thash.hashgrid_bwd}[encoder]
    launches = counter.launches
    count = torch.tensor([37])
    _encoder_launch(encoder, count)
    assert calls[-1][-2:] == (count.data_ptr(), 0)
    _encoder_launch(encoder, None)
    assert calls[-1][-2:] == (None, 0)
    for bad in (torch.tensor([37], dtype=torch.int32),
                torch.tensor([37, 1])):
        with pytest.raises(ValueError, match="count must be one int64"):
            _encoder_launch(encoder, bad)
    assert len(calls) == 2 and counter.launches == launches + 2
    counter.launches = launches
