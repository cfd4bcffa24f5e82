"""The frozen reference and the scene against small cases worked by hand."""
import math

import numpy as np
import pytest
import torch

from portbench import scene
from portbench.reference import compare, composite, field, march, train_step


def test_scene_is_the_same_in_every_run():
    a = scene.make(n_train=3, n_test=4, wh=16, device="cpu")
    b = scene.make(n_train=3, n_test=4, wh=16, device="cpu")
    assert torch.equal(a["images"], b["images"])
    assert np.array_equal(a["poses"], b["poses"])
    assert np.array_equal(a["test_poses"], b["test_poses"])
    assert a["images"].shape == (3, 256, 3)
    assert float(a["images"].min()) >= 0 and float(a["images"].max()) <= 1
    # the spheres fill the middle of every view, white around them
    centre = a["images"][:, 8 * 16 + 8]
    assert (centre < 1).any(dim=1).all()
    assert torch.equal(a["images"][:, 0], torch.ones(3, 3))


def test_scene_cameras_look_at_the_origin():
    poses = scene.test_poses(8)
    for c2w in poses:
        assert np.linalg.norm(c2w[:, 3]) == pytest.approx(scene.CAM_RADIUS)
        assert c2w[:, 3] @ c2w[:, 2] == pytest.approx(-scene.CAM_RADIUS,
                                                      rel=1e-6)
        assert math.degrees(math.asin(c2w[2, 3] / scene.CAM_RADIUS)) \
            == pytest.approx(scene.TEST_ELEVATION, abs=1e-4)


def test_render_hits_the_big_sphere():
    o = torch.tensor([[0.0, 0.0, 1.5], [0.0, 0.0, 1.5]])
    d = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    img = scene.render(o, d)
    assert (img[0] < 1).all() and torch.equal(img[1], torch.ones(3))


def test_ladder_and_codes_by_hand():
    t = march.t_ladder(torch.tensor([0.5]), torch.arange(3), 0.0, 1024,
                       128, 0.5)
    a = march.SQRT3 / 1024
    assert torch.allclose(t, torch.tensor([[0.5, 0.5 + a, 0.5 + 2 * a]]))
    assert march.morton3d(torch.tensor([1, 0, 0])) == 1
    assert march.morton3d(torch.tensor([0, 1, 0])) == 2
    assert march.morton3d(torch.tensor([1, 1, 1])) == 7
    assert march.morton3d(torch.tensor([2, 0, 0])) == 8
    bits = torch.tensor([0b00000100, 0b10000000], dtype=torch.uint8)
    got = march.bitfield_lookup(bits, torch.arange(16))
    assert got.nonzero().flatten().tolist() == [2, 15]
    assert march.n_rungs(0.5, 128, 1024, 0.0) == math.ceil(
        (2 * march.SQRT3 * 0.5) / a) + 1


def test_scene_box_entry_and_exit():
    hits = march.scene_hits(torch.tensor([[0.0, 0.0, 2.0], [0, 0, 2.0]]),
                            torch.tensor([[0.0, 0.0, -1.0], [0, 0, 1.0]]),
                            0.5)
    assert hits.tolist() == [[1.5, 2.5], [-1.0, -1.0]]


def test_march_on_a_full_grid_takes_consecutive_rungs():
    bits = torch.full((16 ** 3 // 8,), 255, dtype=torch.uint8)
    ro = torch.tensor([[0.0, 0.0, 2.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]])
    k = march.n_rungs(0.5, 16, 64, 0.0)
    mr = march.march(ro, rd, march.scene_hits(ro, rd, 0.5), bits, 0.5, 16,
                     64, torch.zeros(1), k, 8)
    a = march.SQRT3 / 64
    assert mr.n_samples.tolist() == [8]
    assert torch.allclose(mr.ts[0], 1.5 + a * torch.arange(8.0))
    assert torch.allclose(mr.deltas[0], torch.full((8,), a))
    cut = march.flat_cut(mr._replace(
        mask=mr.mask.repeat(2, 1), ts=mr.ts.repeat(2, 1),
        deltas=mr.deltas.repeat(2, 1), n_samples=mr.n_samples.repeat(2)), 6)
    assert cut.mask.sum(dim=1).tolist() == [8, 4]   # budget 2 x 6 = 12


def test_nested_levels_fold_exactly():
    assert field.lowrank_levels(8, 256) == (3, 5, 9, 17, 33, 65, 129, 257)
    p = torch.from_numpy(field.prolongation(9, 3))
    u = torch.rand(50)

    def basis(u, k):
        return torch.clamp_min(1 - (u[:, None] * (k - 1)
                                    - torch.arange(k)).abs(), 0)
    assert torch.allclose(basis(u, 9) @ p, basis(u, 3), atol=1e-6)


def test_hat_product_picks_table_rows():
    w = torch.zeros(3, 5, 2)
    w[0, 2, 0], w[1, 2, 0], w[2, 2, 0] = 2.0, 3.0, 4.0
    u = torch.full((1, 3), 0.5)           # knot 2 of 5 on every axis
    got = field.hat_prod_fwd(u, w, 5, "float32")
    assert got.tolist() == [[24.0, 0.0]]
    w.requires_grad_(True)
    field.HatProd.apply(u, w, 5, "float32").sum().backward()
    assert w.grad[0, 2, 0] == 12.0 and w.grad[0, 1, 0] == 0.0


def test_hash_levels_and_a_constant_table():
    hp = dict(grid="MixedFeature", L=16, F=2, T=20, N_min=16, N_max=2048,
              N_tables=8)
    levels, n_params = field.hash_levels(hp, 0.5)
    assert len(levels) == 16 and all(not lv.dense for lv in levels[8:])
    assert n_params == sum({lv.offset: lv.size for lv in levels}.values())
    small = dict(hp, T=10, N_min=4, N_max=32, L=4, N_tables=2)
    levels, n_params = field.hash_levels(small, 0.5)
    table = torch.full((n_params, 2), 0.25)
    out = field.hash_encode(table, torch.rand(7, 3), levels)
    assert torch.allclose(out, torch.full((7, 8), 0.25))


def test_heads_by_hand():
    sh = field.sh_encode(torch.tensor([[0.5, 0.5, 1.0]]))   # d = (0, 0, 1)
    assert sh[0, 0] == pytest.approx(0.28209479177387814)
    assert sh[0, 2] == pytest.approx(0.48860251190291987)
    x = torch.tensor([20.0, 0.0], requires_grad=True)
    field.TruncExp.apply(x).sum().backward()
    assert x.grad[0] == pytest.approx(math.exp(15), rel=1e-5)
    w = [torch.tensor([[1.0, -1.0]]), torch.tensor([[2.0], [3.0]])]
    assert field.mlp(w, torch.tensor([[2.0]])).item() == 4.0


def test_composite_one_sample_by_hand():
    sig, dt = torch.tensor([[2.0, 1.0]]), torch.tensor([[0.5, 0.5]])
    rgb = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    ts = torch.tensor([[1.0, 2.0]])
    mask = torch.tensor([[True, True]])
    a0, a1 = 1 - math.exp(-1.0), 1 - math.exp(-0.5)
    opacity, depth, col = composite.composite_train(sig, rgb, dt, ts, mask,
                                                    1e-4)
    w1 = (1 - a0) * a1
    assert opacity.item() == pytest.approx(a0 + w1, rel=1e-6)
    assert depth.item() == pytest.approx(a0 + 2 * w1, rel=1e-6)
    assert col[0].tolist() == pytest.approx([a0, w1, 0.0], rel=1e-6)
    o, d, c, alive = composite.composite_test_step(
        sig, rgb, dt, ts, mask, torch.zeros(1), torch.zeros(1),
        torch.zeros(1, 3), torch.tensor([True]), 0.5)
    # T after the first sample is 0.37 < 0.5: the second is left out
    assert o.item() == pytest.approx(a0, rel=1e-6) and not alive.item()


def test_schedule_and_adam_inversion():
    hp = dict(lr=1e-2, num_epochs=20, steps_per_epoch=1000)
    assert train_step.learning_rate(hp, 999) == pytest.approx(1e-2)
    assert train_step.learning_rate(hp, 19_000) == pytest.approx(1e-4)
    assert train_step.learning_rate(hp, 10_000) == pytest.approx(
        1e-4 + 0.5 * (1e-2 - 1e-4) * (1 + math.cos(math.pi * 10 / 19)))
    m0, g = {"w": torch.randn(5)}, {"w": torch.randn(5)}
    m1 = {"w": 0.9 * m0["w"] + 0.1 * g["w"]}
    assert torch.allclose(compare.adam_first_grads(m0, m1)["w"].float(),
                          g["w"], atol=1e-5)


def test_numbers_of_identical_and_altered_outputs():
    grads = {"a": torch.ones(4), "b": torch.full((4,), 2.0),
             "c": torch.full((4,), 1e-9)}
    same = compare.train_numbers([1.0], [1.0], grads, grads, grads, grads)
    assert same["loss_gap"] == same["grad_gap"] == same["step_gap"] == 0
    assert list(same["left_out"]) == ["c"]    # under 1e-3 of the median
    moved = compare.train_numbers([1.1], [1.0], grads, grads,
                                  {k: 0 * v for k, v in grads.items()},
                                  grads)
    assert moved["loss_gap"] == pytest.approx(0.1)
    assert moved["step_gap"] == pytest.approx(1.0)
    px = {"rgb": torch.zeros(4, 3), "opacity": torch.zeros(4),
          "depth": torch.zeros(4)}
    off = dict(px, rgb=px["rgb"] + torch.tensor([0.0, 0.0, 0.0, 0.3])[:, None])
    got = compare.frame_numbers(off, px)
    assert got["rgb_gap"] == pytest.approx(0.075)
    assert got["depth_gap"] == 0
