"""The trainer's step, plain, from a snapshot of the trainer's state.

What a training step of ``mfnerf_tpu_torch/train.py::NeRFSystem`` computes
(``_device_step`` and ``step_loss``, ``models/rendering.py::render_train``,
``losses.py::NeRFLoss``, ``cosine_staircase_lr``), as of the benchmark's
first version: a batch of pixels drawn on the device from the trainer's
generator (the image of each ray, its pixel, then the march's start
jitter), their rays, the march with the strata budget and the flat
budget's cut, the field on the kept samples, the composite onto white, the
loss (mean squared error and the opacity entropy at 1e-3) and Adam (eps
1e-15) at the schedule's rate. No capacity buffer and no CUDA graph: the
field runs on the kept samples only.

The trainer's state after its set-up (parameters, Adam's moments, the
occupancy bitfield, the generator's state) is the program's: the
reference starts from it, and computes every step from there itself.
"""
import contextlib
import math

import torch

from . import composite, field, march


@contextlib.contextmanager
def matmul_tf32(on):
    """cuBLAS's float32 matmuls in TF32 while ``on`` (the control), else
    in IEEE float32; the previous setting restored."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def learning_rate(hp, step):
    """The cosine staircase: CosineAnnealingLR(T_max=num_epochs - 1,
    eta_min=lr / 100) stepped once an epoch."""
    lr0 = hp["lr"]
    t_max = max(hp["num_epochs"] - 1, 1)
    epoch = min(step // hp["steps_per_epoch"], t_max)
    eta_min = lr0 * 0.01
    return eta_min + 0.5 * (lr0 - eta_min) * (
        1 + math.cos(math.pi * epoch / t_max))


def dir_norm(directions):
    """The strata's bound on |d|: the cameras' largest, rounded up to a
    sixteenth, at least 1."""
    dn = max(1.0, float(torch.linalg.norm(directions, dim=-1).max()))
    return math.ceil(dn * 16.0) / 16.0


FLAT_AFTER = 512    # the trainer's first step with the flat budget


def step_loss(hp, fld, bits, strata, data, img, pix, noise, flat,
              half=False):
    """The loss of one batch, with the flat budget's cut where ``flat``
    (``half``: the fault that drops the second half of the batch and takes
    the mean over the rest)."""
    rays_o, rays_d = march.get_rays(data["directions"][pix],
                                    data["poses"][img])
    target = data["images"][img, pix][:, :3]
    if half:
        keep = rays_o.shape[0] // 2
        rays_o, rays_d, target, noise = (rays_o[:keep], rays_d[:keep],
                                         target[:keep], noise[:keep])
    scale, g = hp["scale"], hp["grid_size"]
    mr = march.march(rays_o, rays_d, march.scene_hits(rays_o, rays_d, scale),
                     bits, scale, g, hp["max_samples"], noise,
                     march.n_rungs(scale, g, hp["max_samples"], 0.0),
                     hp["s_max_train"], strata=strata)
    if flat:
        mr = march.flat_cut(mr, hp["s_flat"])
    n, s = mr.mask.shape
    idx = torch.nonzero(mr.mask.reshape(-1)).squeeze(1)
    sig, col = fld(mr.xyzs.reshape(-1, 3)[idx], rays_d[idx // s])
    sigmas = sig.new_zeros(n * s).index_put((idx,), sig).reshape(n, s)
    rgbs = col.new_zeros((n * s, 3)).index_put((idx,), col).reshape(n, s, 3)
    opacity, _, rgb = composite.composite_train(
        sigmas, rgbs, mr.deltas, mr.ts, mr.mask, 1e-4)
    rgb = rgb + (1.0 - opacity)[:, None]
    o = opacity + 1e-10
    return ((rgb - target) ** 2).mean() + (1e-3 * (-o * torch.log(o))).mean()


def run_steps(hp, snap, data, n_steps=3, tf32=False, half=False):
    """``n_steps`` training steps from the snapshot ``snap`` (dict:
    ``params`` and ``adam`` by the port's parameter names, ``step``,
    ``bitfield``, ``generator`` state) on the scene ``data`` (dict of
    device tensors: ``images`` (N_img, H*W, 3), ``poses``,
    ``directions``). Returns dict(losses, grads (the first step's, by
    name), params (after the last step, by name))."""
    dev = data["images"].device
    params = {k: v.to(dev).clone().requires_grad_(True)
              for k, v in snap["params"].items()}
    names = list(params)
    opt = torch.optim.Adam([params[k] for k in names], lr=hp["lr"],
                           eps=1e-15, foreach=False)
    for k in names:
        st = snap["adam"][k]
        opt.state[params[k]] = {
            "step": torch.tensor(float(st["step"])),
            "exp_avg": st["exp_avg"].to(dev).clone(),
            "exp_avg_sq": st["exp_avg_sq"].to(dev).clone()}
    bits = snap["bitfield"].to(dev)
    strata = march.strata_of(hp, bits, dir_norm(data["directions"]))
    gen = torch.Generator(device=dev)
    gen.set_state(snap["generator"])
    b = hp["batch_size"]
    n_img, hw = data["images"].shape[:2]
    losses, first = [], None
    with matmul_tf32(tf32):
        for i in range(n_steps):
            img = torch.randint(n_img, (b,), generator=gen, device=dev)
            pix = torch.randint(hw, (b,), generator=gen, device=dev)
            noise = torch.rand((b,), generator=gen, device=dev)
            fld = field.Field(hp, params)
            flat = bool(hp.get("s_flat")) and snap["step"] + i >= FLAT_AFTER
            loss = step_loss(hp, fld, bits, strata, data, img, pix, noise,
                             flat, half)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if first is None:
                first = {k: params[k].grad.detach().clone() for k in names}
            for group in opt.param_groups:
                group["lr"] = learning_rate(hp, snap["step"] + i)
            opt.step()
            losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: params[k].detach() for k in names}}
