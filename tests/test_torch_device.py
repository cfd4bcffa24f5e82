"""The port's entry points run on the CUDA device unless the caller asks
for the CPU. Without a CUDA device each of them raises when no device is
given; it never falls back to the CPU. Given ``device="cpu"`` each works."""
import argparse

import numpy as np
import pytest
import torch

from mfnerf_tpu_torch.models.ngp import NGP, NGPConfig, OccupancyState
from mfnerf_tpu_torch.train import NeRFSystem
from mfnerf_tpu_torch.utils.ckpt import occupancy_from_numpy

CFG = NGPConfig(lr_levels=2, lr_rank=8, lr_k_max=32, grid_size=16,
                lr_fused=True)


def _hparams():
    return argparse.Namespace(
        dataset_name="nsvf", scale=0.5, use_exposure=False,
        distortion_loss_w=0.0, batch_size=64, num_epochs=1, lr=1e-2,
        optimize_ext=False, random_bg=False, grid="LowRank", L=16, F=2,
        rgb_channels=16, rgb_layers=1, seed=1, s_max_train=16,
        s_max_test=32, test_chunk=1024, grid_size=16, max_samples=128,
        lr_levels=2, lr_rank=8, lr_k_max=32, lr_fused=True)


def _occ_section():
    return {"density_bitfield": np.zeros(CFG.n_cells // 8, np.uint8)}


ENTRY_POINTS = {
    "NeRFSystem": lambda **kw: NeRFSystem(_hparams(), **kw).device,
    "NGP": lambda **kw: NGP(CFG, **kw).device,
    "OccupancyState.create": lambda **kw: OccupancyState.create(
        CFG, **kw).density_grid.device,
    "occupancy_from_numpy": lambda **kw: occupancy_from_numpy(
        _occ_section(), CFG, **kw).density_bitfield.device,
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_cuda_unless_asked_for_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = ENTRY_POINTS[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(device="cuda")
    assert make(device="cpu") == torch.device("cpu")
